// K2h's digit kernel on int16 lanes (D = 2: each element as 2 byte digits
// through the s8/u8 tensor-core MMAs) with the tail's modes of K2H_MODES[1]
// compiled in: every tail merge TRN::TCPL, SAT::ZERO. One instantiation of
// k2h::launch_modes (tree_gemm_hybrid_mma.cuh), in a file of its own so that
// it compiles in parallel with the others.

#include "tree_gemm_hybrid_mma.cuh"

namespace k2h {
K2H_DIGIT_INSTANCE(2, 1);
}  // namespace k2h
