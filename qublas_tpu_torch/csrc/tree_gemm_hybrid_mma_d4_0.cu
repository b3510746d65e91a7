// K2h's digit kernel on int32 lanes (D = 4: each element as 4 byte digits
// through the s8/u8 tensor-core MMAs) with the tail's modes read at run time
// (every plan whose tail modes no entry of K2H_MODES has). One instantiation
// of k2h::launch_modes (tree_gemm_hybrid_mma.cuh), in a file of its own so
// that it compiles in parallel with the others.

#include "tree_gemm_hybrid_mma.cuh"

namespace k2h {
K2H_DIGIT_INSTANCE(4, 0);
}  // namespace k2h
