// Variants of the package's K2' kernel (csrc/tree_gemm_stream.cuh, included
// here), timed by experiments/kernel_sweeps.py to choose its design: the
// load path, the slice length, how much of the requantize step is compiled
// in, the micro-tile, the stack depth.  Not part of the package's kernels.
//
// kernel_sweeps.py compiles this file once for each K2S_VARIANT, all at
// once, into one library; each defines k2s_variant_<K2S_VARIANT>.  The
// package's own instantiations (compiled steps, and steps read at run
// time) are timed through its entry point.

#include "tree_gemm_stream.cuh"

namespace {

// k-slices by 16-byte cp.async from every thread, one commit group a
// slice, instead of TMA.
struct CpAsyncLoad {
  struct Args {
    const int32_t* a;
    const int32_t* b;
    long long lda;
    long long ldb;
  };

  static bool make(Args* g, const int32_t* a, long long lda, const int32_t* b,
                   long long ldb, int, int, int, int, int, int) {
    *g = Args{a, b, lda, ldb};
    return true;
  }

  static __device__ __forceinline__ void init(uint64_t*) {}

  static __device__ __forceinline__ void copy16(int32_t* dst,
                                                const int32_t* src,
                                                bool valid) {
    // src-size 0 writes zeros and reads nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     k2s::smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  }

  template <int TBM, int TBN, int S>
  static __device__ __forceinline__ void issue(const Args& g, int32_t* as,
                                               int32_t* bs, uint64_t*,
                                               int k0, int m0, int n0, int M,
                                               int N, int K, bool valid) {
    if (valid) {
      for (int e = threadIdx.x; e < TBM * S / 4; e += k2s::THREADS) {
        const int r = e / (S / 4);
        const int c = (e % (S / 4)) * 4;
        const bool ok = m0 + r < M && k0 + c < K;
        copy16(as + r * S + c, ok ? g.a + (size_t)(m0 + r) * g.lda + k0 + c
                                  : g.a,
               ok);
      }
      for (int e = threadIdx.x; e < S * TBN / 4; e += k2s::THREADS) {
        const int r = e / (TBN / 4);
        const int c = (e % (TBN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        copy16(bs + r * TBN + c, ok ? g.b + (size_t)(k0 + r) * g.ldb + n0 + c
                                    : g.b,
               ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  static __device__ __forceinline__ void wait(uint64_t*, int) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(k2s::STAGES - 1)
                 : "memory");
    __syncthreads();
  }
};

// The slice unrolled with only the canonical (round, overflow) modes fixed,
// as K2 has them: shift, width and signedness read at run time.
struct ModesOnly {
  static constexpr bool UNROLLED = true;

  static __device__ __forceinline__ int32_t product(const TreeParams& p,
                                                    int32_t a, int32_t b) {
    const qk::Rq r = qk::with_modes<qk::TRN_TCPL, qk::SAT_ZERO>(p.prod);
    return qk::product_rq(p.route, a, b, r);
  }

  static __device__ __forceinline__ int32_t convert(const qk::Fold& f, int l,
                                                    int32_t x) {
    return qk::requant(
        x, qk::with_modes<qk::TRN_TCPL, qk::SAT_ZERO>(f.merge[l]));
  }

  static __device__ __forceinline__ int32_t merge(const qk::Fold& f, int l,
                                                  int32_t left,
                                                  int32_t right) {
    return convert(f, l, qk::wadd(left, right));
  }
};

using k2s::TmaLoad;
using Compiled = k2s::Steps<1>;

}  // namespace

#define K2S_NAME2(a, b) a##b
#define K2S_NAME(a, b) K2S_NAME2(a, b)

// Each variant's stack depth: the package's K2S_TOP (k below 4096), or for
// the variants from 8 on the depths that k from 4096 can take.
#if K2S_VARIANT >= 8 && K2S_VARIANT <= 10
#define K2S_VARIANT_TOP 14
#elif K2S_VARIANT == 11
#define K2S_VARIANT_TOP 13
#elif K2S_VARIANT == 12
#define K2S_VARIANT_TOP qk::MAXL
#else
#define K2S_VARIANT_TOP qk::K2S_TOP
#endif

// The variant on A [m, k] (pitch lda) and B [k, n] (pitch ldb), C [m, n]
// int32; params as ops/tree_gemm.py:_kernel_params writes them with
// log_blk = 0, the canonical plan where the variant compiles its steps;
// k below 2^TOP.
extern "C" int K2S_NAME(k2s_variant_, K2S_VARIANT)(
    const void* a, long long lda, const void* b, long long ldb, void* c,
    int m, int n, int k, const int* params) {
  constexpr int TOP = K2S_VARIANT_TOP;
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || log_blk != 0 ||
      bit_length(k) > TOP) {
    return -1;
  }
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
#if K2S_VARIANT == 1  // 16-byte cp.async instead of TMA
  return k2s::launch<TOP, Compiled, 4, 1, 3, 5, CpAsyncLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 2  // slices of 16 products
  return k2s::launch<TOP, Compiled, 4, 1, 3, 4, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 3  // only the modes compiled in
  return k2s::launch<TOP, ModesOnly, 4, 1, 3, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 4  // 2 x 1 outputs a thread, 4 blocks an SM
  return k2s::launch<TOP, Compiled, 2, 1, 4, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 5  // 4 x 1 outputs a thread, 2 blocks an SM
  return k2s::launch<TOP, Compiled, 4, 1, 2, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 6  // 2 x 2 outputs a thread, 2 blocks an SM
  return k2s::launch<TOP, Compiled, 2, 2, 2, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 7  // 2 x 2 outputs a thread, 3 blocks an SM
  return k2s::launch<TOP, Compiled, 2, 2, 3, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 8  // depth 14, 4 x 1 outputs a thread, 3 blocks an SM
  return k2s::launch<TOP, Compiled, 4, 1, 3, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 9  // depth 14, 2 x 1 outputs a thread, 4 blocks an SM
  return k2s::launch<TOP, Compiled, 2, 1, 4, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 10  // depth 14, 4 x 1 outputs a thread, 2 blocks an SM
  return k2s::launch<TOP, Compiled, 4, 1, 2, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 11  // depth 13, 4 x 1 outputs a thread, 3 blocks an SM
  return k2s::launch<TOP, Compiled, 4, 1, 3, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#elif K2S_VARIANT == 12  // depth MAXL, 1 output a thread, 2 blocks an SM
  return k2s::launch<TOP, Compiled, 1, 1, 2, 5, TmaLoad>(
      A, lda, B, ldb, c, m, n, k, 4, p, nullptr);
#else
#error "K2S_VARIANT must be 1-12"
#endif
}
