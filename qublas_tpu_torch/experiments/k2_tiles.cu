// The package's tiled K2 kernel (csrc/tree_gemm_tiled.cuh, included here)
// on other micro-tiles and occupancy targets, timed by
// experiments/kernel_sweeps.py to choose the tile.  Not part of the
// package's kernels.

#include "tree_gemm_tiled.cuh"

// The tiled K2 on a (TM x TN) micro-tile with MINB blocks an SM, the
// canonical modes fixed (modes 1) or read at run time (modes 0); params as
// ops/tree_gemm.py:_kernel_params writes them with log_blk = 4, k / 16
// full blocks below 256 (TOP = 8).  Output int32.
extern "C" int k2_tiled_variant(int tm, int tn, int minb, int modes,
                                const void* a, const void* b, void* c, int m,
                                int n, int k, const int* params) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || log_blk != 4 ||
      (k >> 4) >= 256) {
    return -1;
  }
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
  constexpr int ANY = qk::ANY, T = qk::TRN_TCPL, Z = qk::SAT_ZERO;
  const int key = tm * 1000 + tn * 100 + minb * 10 + modes;
  switch (key) {
#define CASE(TM, TN, MB)                                                     \
  case TM * 1000 + TN * 100 + MB * 10 + 1:                                   \
    launch_tiled<8, TM, TN, MB, T, Z>(A, B, c, m, n, k, 4, p, nullptr);      \
    break;                                                                   \
  case TM * 1000 + TN * 100 + MB * 10:                                       \
    launch_tiled<8, TM, TN, MB, ANY, ANY>(A, B, c, m, n, k, 4, p, nullptr);  \
    break;
    CASE(4, 2, 1)
    CASE(2, 2, 3)
    CASE(4, 1, 2)
    CASE(2, 1, 3)
    CASE(1, 2, 3)
    CASE(2, 1, 4)
    CASE(1, 1, 4)
#undef CASE
    default: return -1;
  }
  return (int)cudaGetLastError();
}
