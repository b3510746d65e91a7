// K2 for k below 4096 (TOP = 8), with the canonical modes (TRN::TCPL,
// SAT::ZERO) and the 64-bit product route fixed: one instantiation of
// qk::launch_k2 (tree_gemm_tiled.cuh), in a file of its own so that it
// compiles in parallel with the others.

#include "tree_gemm_tiled.cuh"

namespace qk {
QK_K2_INSTANCE(8, 2);
}  // namespace qk
