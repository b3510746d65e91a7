// K2 for k below 4096 (TOP = 8), with the modes read at run time: one
// instantiation of qk::launch_k2
// (tree_gemm_tiled.cuh), in a file of its own so that it compiles in
// parallel with the others.

#include "tree_gemm_tiled.cuh"

namespace qk {
QK_K2_INSTANCE(8, 0);
}  // namespace qk
