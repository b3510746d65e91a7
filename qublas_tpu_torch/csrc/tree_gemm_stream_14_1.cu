// K2' for k from 4096 below 16384 (TOP = K2S_TOP2 = 14), with the
// canonical plan's requantize steps compiled in (K2S_PLANS[1]): one
// instantiation of qk::launch_k2s (tree_gemm_stream.cuh), in a file of its
// own so that it compiles in parallel with the others.

#include "tree_gemm_stream.cuh"

namespace qk {
QK_K2S_INSTANCE(K2S_TOP2, 1);
}  // namespace qk
