// K3 with BASELINE config 2's modes fixed, (RND::CONV, SAT::ZERO) at tree
// level 0 and (TRN::TCPL, SAT::TCPL) above it: the warp kernel on int8
// rows with 32 leaves a lane, and the columns kernel in blocks of 16
// (qreduce.cuh), in a file of their own so that they compile in parallel
// with the others.

#include "qreduce.cuh"

namespace qk {
QK_K3_WARP(int8_t, 5, WARP_TOP, 1);
QK_K3_COLS(4, 16, 1);
}  // namespace qk
