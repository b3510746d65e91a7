// K2: the order-sensitive quantized tree GEMM, for qgemul's general tier
// (e.g. the canonical Qu<8,8,TRN::TCPL,SAT::ZERO> config).
//
// Replaces qublas_tpu/ops/tree_gemm.py:tree_gemm_blocked (a Pallas kernel
// that folds each 32-product k-block in VMEM, then a separate jnp phase 2
// over the per-block values in HBM) and tree_gemm_pallas (one pass over k
// with a binary-carry slot stack in VMEM scratch).  Here one thread owns one
// output element and runs tree_gemm_scan's schedule, which is proven for
// any k (qublas_tpu/ops/tree_gemm.py:252-337):
//   * blocks of blk = the largest power of two dividing k, capped at 16;
//   * per block, blk requantized products (route "i32" or "split") folded
//     through the first log2(blk) tree layers in registers;
//   * the block value pushed onto a binary-carry slot stack (one partial
//     per tree level above the block), merging once per trailing one-bit
//     of the block index;
//   * the plan's drain ops (seed/convert/add) over the ragged right edge,
//     then the final requantize into the output format.
// The slot stack is an array with a compile-time size and only static
// indices (unrolled loops, select-by-compare), so it stays in registers; no
// block value ever goes to device memory, so there is no phase-2 pass.
//
// What bounds it: int32 ALU work, about 14 operations per product (split
// multiply, rounding carry, saturation, an amortised tree merge), against
// two 4-byte operand loads that the L1 cache serves (a warp shares its A
// element and reads 32 neighbouring B elements).  Compute-bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int MAXL = 32;  // tree levels: k < 2^31

enum Op : int { SEED = 0, CONVERT = 1, ADD = 2 };

struct TreeParams {
  int split;             // product route: 0 = "i32", 1 = "split"
  qk::Rq prod;           // product requantize into the mul format
  qk::Rq merge[MAXL];    // layer l: level_fmts[l] -> merge_fmts[l]
  int ndrain;
  int drain_op[2 * MAXL];
  int drain_lvl[2 * MAXL];
  qk::Rq fin;            // final_fmt -> out_fmt
};

__device__ __forceinline__ int32_t product(const TreeParams& p, int32_t a,
                                           int32_t b) {
  return p.split ? qk::requant_split_mul(a, b, p.prod)
                 : qk::requant(qk::wmul(a, b), p.prod);
}

template <int TOP>
__device__ __forceinline__ int32_t pick(const int32_t (&s)[TOP], int idx) {
  int32_t r = s[0];
#pragma unroll
  for (int q = 1; q < TOP; ++q) {
    if (q == idx) r = s[q];
  }
  return r;
}

// A [M, K], B [K, N] int32; K is a multiple of 2^LOG_BLK and
// K / 2^LOG_BLK < 2^TOP.
template <int LOG_BLK, int TOP>
__global__ void __launch_bounds__(256)
tree_gemm_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                 void* __restrict__ C, int M, int N, int K, int out_bytes,
                 const TreeParams p) {
  constexpr int BLK = 1 << LOG_BLK;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= M || j >= N) return;
  const int32_t* arow = A + (size_t)i * K;
  const int32_t* bcol = B + j;
  const int nblocks = K >> LOG_BLK;

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;

  for (int t = 0; t < nblocks; ++t) {
    int32_t v[BLK];
#pragma unroll
    for (int q = 0; q < BLK; ++q) {
      const size_t kk = ((size_t)t << LOG_BLK) + q;
      v[q] = product(p, __ldg(arow + kk), __ldg(bcol + kk * N));
    }
    // in-block tree layers 0 .. LOG_BLK-1 (left operand first)
#pragma unroll
    for (int l = 0; l < LOG_BLK; ++l) {
#pragma unroll
      for (int q = 0; q < (BLK >> (l + 1)); ++q) {
        v[q] = qk::requant(qk::wadd(v[2 * q], v[2 * q + 1]), p.merge[l]);
      }
    }
    // push: merge with the slot of each trailing one-bit of t, then store
    int32_t val = v[0];
    const int cnt = __ffs(~t) - 1;
#pragma unroll
    for (int l = 0; l < TOP; ++l) {
      if (LOG_BLK + l < MAXL && l < cnt) {
        val = qk::requant(qk::wadd(slot[l], val), p.merge[LOG_BLK + l]);
      }
    }
#pragma unroll
    for (int l = 0; l < TOP; ++l) {
      if (l == cnt) slot[l] = val;
    }
  }

  // drain the binary-carry ragged edge (tree_gemm.py:_drain)
  int32_t carry = 0;
  for (int s = 0; s < p.ndrain; ++s) {
    const int l = p.drain_lvl[s];
    if (p.drain_op[s] == CONVERT) {
      carry = qk::requant(carry, p.merge[l]);
      continue;
    }
    const int32_t sv = pick(slot, l > LOG_BLK ? l - LOG_BLK : 0);
    carry = p.drain_op[s] == SEED
                ? sv
                : qk::requant(qk::wadd(sv, carry), p.merge[l]);
  }
  qk::store_lane(C, (size_t)i * N + j, qk::requant(carry, p.fin), out_bytes);
}

template <int LOG_BLK, int TOP>
void launch(const int32_t* a, const int32_t* b, void* c, int m, int n, int k,
            int out_bytes, const TreeParams& p, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (m + 7) / 8);
  tree_gemm_kernel<LOG_BLK, TOP><<<grid, block, 0, stream>>>(a, b, c, m, n, k,
                                                             out_bytes, p);
}

template <int LOG_BLK>
void launch_top(int top, const int32_t* a, const int32_t* b, void* c, int m,
                int n, int k, int out_bytes, const TreeParams& p,
                cudaStream_t stream) {
  if (top <= 8) {
    launch<LOG_BLK, 8>(a, b, c, m, n, k, out_bytes, p, stream);
  } else if (top <= 16) {
    launch<LOG_BLK, 16>(a, b, c, m, n, k, out_bytes, p, stream);
  } else {
    launch<LOG_BLK, MAXL>(a, b, c, m, n, k, out_bytes, p, stream);
  }
}

qk::Rq read_rq(const int* q) { return qk::Rq{q[0], q[1], q[2], q[3], q[4]}; }

}  // namespace

// params (host int32), as qublas_tpu_torch/ops/tree_gemm.py:_kernel_params
// writes them:
//   split, log_blk, prod[5], levels, merge[levels][5], ndrain,
//   (op, level)[ndrain], fin[5]
// Returns a cudaError_t, or -1 for parameters outside the kernel's range.
extern "C" int qk_tree_gemm(int device, const void* a, const void* b, void* c,
                            int m, int n, int k, int out_bytes,
                            const int* params, void* stream) {
  TreeParams p{};
  const int* q = params;
  p.split = *q++;
  const int log_blk = *q++;
  p.prod = read_rq(q);
  q += 5;
  const int levels = *q++;
  if (levels < 1 || levels > MAXL || log_blk < 0 || log_blk > 4) return -1;
  for (int l = 0; l < levels; ++l, q += 5) p.merge[l] = read_rq(q);
  p.ndrain = *q++;
  if (p.ndrain < 0 || p.ndrain > 2 * MAXL) return -1;
  for (int s = 0; s < p.ndrain; ++s) {
    p.drain_op[s] = *q++;
    p.drain_lvl[s] = *q++;
  }
  p.fin = read_rq(q);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = k >> log_blk;
  int top = 1;
  while (top < 31 && (nblocks >> top) != 0) ++top;  // bit_length(nblocks)
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log_blk) {
    case 0: launch_top<0>(top, A, B, c, m, n, k, out_bytes, p, s); break;
    case 1: launch_top<1>(top, A, B, c, m, n, k, out_bytes, p, s); break;
    case 2: launch_top<2>(top, A, B, c, m, n, k, out_bytes, p, s); break;
    case 3: launch_top<3>(top, A, B, c, m, n, k, out_bytes, p, s); break;
    default: launch_top<4>(top, A, B, c, m, n, k, out_bytes, p, s); break;
  }
  return (int)cudaGetLastError();
}
