// K3 with the layered canonical GEMM's modes fixed, (TRN::TCPL,
// SAT::ZERO) at every tree level: the warp kernel on int8 rows with 16
// leaves a lane, and the columns kernel in blocks of 16 (qreduce.cuh), in
// a file of their own so that they compile in parallel with the others.

#include "qreduce.cuh"

namespace qk {
QK_K3_WARP(int8_t, 5, WARP_TOP, 2);
QK_K3_COLS(4, 16, 2);
}  // namespace qk
