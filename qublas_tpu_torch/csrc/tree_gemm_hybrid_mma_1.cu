// K2h's tensor-core kernel with the tail's modes of K2H_MODES[1] compiled
// in: every tail merge TRN::TCPL, SAT::ZERO (the JAX package's hybrid
// configurations at k = 16t).  One instantiation of k2h::launch_modes
// (tree_gemm_hybrid_mma.cuh), in a file of its own so that it compiles in
// parallel with the others.

#include "tree_gemm_hybrid_mma.cuh"

namespace k2h {
K2H_INSTANCE(1);
}  // namespace k2h
