// K2' for k from 16384 (TOP = 32), with the canonical plan's requantize
// steps compiled in (K2S_PLANS[1]): one instantiation of qk::launch_k2s
// (tree_gemm_stream.cuh), in a file of its own so that it compiles in
// parallel with the others.

#include "tree_gemm_stream.cuh"

namespace qk {
QK_K2S_INSTANCE(MAXL, 1);
}  // namespace qk
