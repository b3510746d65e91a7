// The tree GEMM's parameters, its requantized product and the reader of
// the host's parameter array, shared by K2 (tree_gemm_tiled.cu), K2'
// (tree_gemm_stream.cu) and P1 (tree_gemm.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"
#include "tree_fold.cuh"

namespace qk {

// The product routes (widths.route_mul), as ops/tree_gemm.py:ROUTES codes
// them: the int32 product, the split-B int32 product, the 64-bit product.
enum Route : int { ROUTE_I32 = 0, ROUTE_SPLIT = 1, ROUTE_PAIR = 2 };
// An instantiation's route where it reads one of the two int32 routes at
// run time (beside one Route, or ANY: all three at run time).
constexpr int INT32_ROUTES = -2;

struct TreeParams {
  int route;             // product route: a Route
  Rq prod;               // product requantize into the mul format
  Fold fold;             // tree layers and drain
  Rq fin;                // final_fmt -> out_fmt
};

// The requantized product of a and b by route, with the product's step r.
__device__ __forceinline__ int32_t product_rq(int route, int32_t a,
                                              int32_t b, const Rq& r) {
  if (route == ROUTE_SPLIT) return requant_split_mul(a, b, r);
  if (route == ROUTE_PAIR) return requant64((int64_t)a * b, r);
  return requant(wmul(a, b), r);
}

__device__ __forceinline__ int32_t product(const TreeParams& p, int32_t a,
                                           int32_t b) {
  return product_rq(p.route, a, b, p.prod);
}

// params (host int32), as qublas_tpu_torch/ops/tree_gemm.py:_kernel_params
// writes them:
//   route, log_blk, prod[5], levels, merge[levels][5], ndrain,
//   (op, level)[ndrain], fin[5]
// Returns false for parameters outside the kernels' range.
inline bool read_params(const int* params, TreeParams* p, int* log_blk) {
  const int* q = params;
  p->route = *q++;
  *log_blk = *q++;
  p->prod = read_rq(q);
  q = read_fold(q + 5, &p->fold);
  if (q == nullptr || *log_blk < 0 || *log_blk > 4 || p->route < ROUTE_I32 ||
      p->route > ROUTE_PAIR) {
    return false;
  }
  p->fin = read_rq(q);
  return true;
}

inline int bit_length(long long x) {
  int b = 0;
  while (x >> b) ++b;
  return b;
}

}  // namespace qk

namespace {
using qk::bit_length;
using qk::product;
using qk::read_params;
using qk::TreeParams;
}  // namespace
