// The tree GEMM's parameters, its requantized product and the reader of
// the host's parameter array, shared by K2 (tree_gemm_tiled.cu), K2'
// (tree_gemm_stream.cu) and P1 (tree_gemm.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"
#include "tree_fold.cuh"

namespace qk {

struct TreeParams {
  int split;             // product route: 0 = "i32", 1 = "split"
  Rq prod;               // product requantize into the mul format
  Fold fold;             // tree layers and drain
  Rq fin;                // final_fmt -> out_fmt
};

__device__ __forceinline__ int32_t product(const TreeParams& p, int32_t a,
                                           int32_t b) {
  return p.split ? requant_split_mul(a, b, p.prod)
                 : requant(wmul(a, b), p.prod);
}

// params (host int32), as qublas_tpu_torch/ops/tree_gemm.py:_kernel_params
// writes them:
//   split, log_blk, prod[5], levels, merge[levels][5], ndrain,
//   (op, level)[ndrain], fin[5]
// Returns false for parameters outside the kernels' range.
inline bool read_params(const int* params, TreeParams* p, int* log_blk) {
  const int* q = params;
  p->split = *q++;
  *log_blk = *q++;
  p->prod = read_rq(q);
  q = read_fold(q + 5, &p->fold);
  if (q == nullptr || *log_blk < 0 || *log_blk > 4) return false;
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
