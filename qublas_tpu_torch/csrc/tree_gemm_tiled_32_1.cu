// K2 for any k (TOP = 32), with the canonical modes (TRN::TCPL,
// SAT::ZERO) fixed: one instantiation of qk::launch_k2
// (tree_gemm_tiled.cuh), in a file of its own so that it compiles in
// parallel with the others.

#include "tree_gemm_tiled.cuh"

namespace qk {
QK_K2_INSTANCE(MAXL, 1);
}  // namespace qk
