// K2h's tensor-core kernel with the tail's modes of K2H_MODES[2] compiled
// in: TRN::TCPL, tree level L's merge SAT::TCPL and the merges above
// SAT::ZERO (the JAX package's hybrid configuration at k = 8 mod 16).  One
// instantiation of k2h::launch_modes (tree_gemm_hybrid_mma.cuh), in a file
// of its own so that it compiles in parallel with the others.

#include "tree_gemm_hybrid_mma.cuh"

namespace k2h {
K2H_INSTANCE(2);
}  // namespace k2h
