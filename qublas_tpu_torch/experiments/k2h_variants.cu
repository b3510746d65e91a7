// The block dots of K2h's tensor-core kernels without their tail
// (csrc/tree_gemm_hybrid_mma.cuh, included here), timed by
// experiments/kernel_sweeps.py (part k2h) to see what bounds the dots: as
// the int8 kernel reads its operands, on cache-resident operand rows, at
// the occupancy of the stages' shared memory alone, and as the digit
// kernel reads int16 operands (D = 2).  Not part of the package's
// kernels.

#include "tree_gemm_hybrid_mma.cuh"

namespace {

using k2h::OUTS;

// The block dots alone: a pair's sums pass as they are, the merges are
// xors, the push an xor into the registers of stack level 0; no requantize
// and no shared stack.
struct DotsOnly {
  static constexpr bool UNROLL = true;
  static __device__ __forceinline__ void pair(const qk::Fold&,
                                              int32_t (&)[OUTS]) {}
  template <int l>
  static __device__ __forceinline__ void merge(const qk::Fold&,
                                               const int32_t (&slot)[OUTS],
                                               int32_t (&v)[OUTS]) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) v[o] ^= slot[o];
  }
  template <class Slots>
  static __device__ __forceinline__ void push(Slots& s, int32_t (&v)[OUTS],
                                              int, const qk::Fold&) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) s.l0[o] ^= v[o];
  }
};

// lda, ldb: the operands' row pitches in elements of D bytes
template <int D = 1>
int dots(const void* a, long long lda, const void* b, long long ldb, void* c,
         int m, int n, int k, int out_bytes, int levels,
         const HybridParams& p) {
  return k2h::launch<DotsOnly, D>(0, a, lda * D, b, ldb * D, c, m, n, k,
                                  out_bytes, levels, p, nullptr);
}

}  // namespace

// Variant 1: the dots alone; 2: the dots alone with every row of A and of
// B read from their first rows (row pitch 0: the stages' copies hit the
// caches); 3: the dots alone with the shared memory of the stages only and
// no drain (the blocks an SM that the stack's shared memory costs); 4: the
// digit kernel's dots alone on int16 A and B (four MMAs a k16 step and n8
// tile, the digit planes' byte permutes, the classes' sum).  On device 0
// and the default stream; -1 for arguments outside the kernel's range.
extern "C" int k2h_variant(int variant, const void* a, long long lda,
                           const void* b, long long ldb, void* c, int m,
                           int n, int k, int out_bytes, const int* params) {
  HybridParams p{};
  int levels;
  if (!read_hybrid(params, m, n, k, out_bytes, &p, &levels)) return -1;
  switch (variant) {
    case 1:
      return dots(a, lda, b, ldb, c, m, n, k, out_bytes, levels, p);
    case 2:
      return dots(a, 0, b, 0, c, m, n, k, out_bytes, levels, p);
    case 3:
      p.fold.ndrain = 0;
      return dots(a, lda, b, ldb, c, m, n, k, out_bytes, 1, p);
    case 4:
      return dots<2>(a, lda, b, ldb, c, m, n, k, out_bytes, levels, p);
    default:
      return -1;
  }
}
