// K2' for k below 4096 (TOP = 12), with every requantize step read at
// run time: one instantiation of qk::launch_k2s (tree_gemm_stream.cuh),
// in a file of its own so that it compiles in parallel with the others.

#include "tree_gemm_stream.cuh"

namespace qk {
QK_K2S_INSTANCE(K2S_TOP, 0);
}  // namespace qk
