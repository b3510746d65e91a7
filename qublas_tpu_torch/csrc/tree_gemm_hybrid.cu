// K2h: the prefix-lossless hybrid tree GEMM, for qgemul's hybrid tier:
// the IMAD kernel, for int16 and int32 lanes (int8 x int8 operands take the
// tensor-core kernel, tree_gemm_hybrid_mma.cu; the tensor cores take no
// s16 or s32 operand).
//
// Replaces qublas_tpu/ops/tree_gemm.py:tree_gemm_hybrid, which the JAX
// package runs as an XLA einsum (the exact int32 dot of every block of
// s = 2^L products, into a [k/s, m, n] int32 intermediate in device
// memory: 2 GiB at 2048^3 with s = 16) and then the quantized tree tail as
// VPU requantize folds.  When the product's requantize and the first L >= 3
// tree layers are provably lossless (ops/tree_gemm.py:plan_hybrid), the
// value at tree level L of each 2^L-product subtree is the plain integer
// dot of that k-block shifted left by dl, and only the tail from level L
// up rounds and saturates.
//
// Here nothing goes to device memory between the dot and the output: K2's tiled
// layout (tree_gemm_tiled.cu), with k-slices of 16 products of A (transposed)
// and B arriving by cp.async into two shared-memory buffers (tile_stage.cuh,
// shared with K2), each thread owning a 4 x 2 register micro-tile.  The leaf
// changes: in place of a requantized product folded through levels 0-3, each
// output accumulates the exact int32 dot of its current block (one IMAD a
// product; wrapping arithmetic, as XLA's int32 dot wraps raws outside the
// operands' formats).  A slice is two halves of 8 products, and s >= 8 divides
// k, so a block ends only after a half: there the dots, shifted by dl, go onto
// the binary-carry slot stack of tree levels L and up (one merge per trailing
// one-bit of the block's index, the slot the earlier, left operand, as
// tree_fold.cuh's push).  The plan's drain over the k / s block values
// (drain_ops(k / s, levels - L), offset by L) finishes the tail's odd
// edges.  The tail's modes are read at run time, its merges inlined.  The
// parameters, the push and the drain are hybrid_tail.cuh's, shared with
// the tensor-core kernel.
//
// Bound: the M N K multiply-adds at the SMs' int32 issue rate; the tail's
// M N K / s merges and the operand bytes are far below it.  So the block
// dots stay in a tight loop of shared loads (one 16-byte and one 8-byte a
// product for eight IMADs) and IMADs; the tail, one push in s products,
// stays out of it: one push site a half slice, its carries in a rolled
// loop, and the slot stack in local memory (it is indexed at run time and
// touched once a block), which leaves the registers to the micro-tile and
// four blocks an SM.  (Unrolled over every level and output, with an
// inlined run-time requantize each, the push was some 128 copies of the
// requantize, and the kernel ran at 5% of its bound: PERF.md §6.)

#include "hybrid_tail.cuh"
#include "tile_stage.cuh"

namespace {

constexpr int SLICE = 16;    // products a k-slice
constexpr int HALF = 1 << HYB_MIN_LEVEL;  // products a half slice: s >= 8
constexpr int THREADS = 256; // 16 x 16, each a TM x TN micro-tile
constexpr int TM = 4;
constexpr int TN = 2;
constexpr int MINB = 4;      // blocks an SM

// The slot stack of tree levels p.level and up, in local memory: indexed
// at run time and touched once a block.
template <int OUTS>
struct LocalSlots {
  int32_t v[OUTS][qk::MAXL];
  __device__ int32_t get(int o, int l) const { return v[o][l]; }
  __device__ void set(int o, int l, int32_t x) { v[o][l] = x; }
};

// A [M, K], B [K, N] int32 row-major, K a multiple of 2^p.level >= 8.
__global__ void __launch_bounds__(THREADS, MINB)
tree_gemm_hybrid_kernel(const int32_t* __restrict__ A,
                        const int32_t* __restrict__ B, void* __restrict__ C,
                        int M, int N, int K, int out_bytes,
                        const HybridParams p) {
  constexpr int TBM = 16 * TM;  // tile rows
  constexpr int TBN = 16 * TN;  // tile columns
  constexpr int LDA = TBM + 4;  // As[k][row], 16-byte aligned rows
  constexpr int OUTS = TM * TN;
  __shared__ __align__(16) int32_t As[2][SLICE][LDA];
  __shared__ __align__(16) int32_t Bs[2][SLICE][TBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * TBM;
  const int n0 = blockIdx.x * TBN;

  // copy k-slice s into buffer buf
  auto stage = [&](int s, int buf) {
    stage_slice<SLICE, TBM, TBN, LDA, THREADS>(As[buf], Bs[buf], A, B, M,
                                               N, K, m0, n0, s);
  };

  int32_t acc[OUTS];  // the running block's dot
  LocalSlots<OUTS> slot;
#pragma unroll
  for (int o = 0; o < OUTS; ++o) acc[o] = 0;

  const int bmask = (1 << p.level) - 1;
  const int slices = (K + SLICE - 1) / SLICE;
  stage(0, 0);
  int t = 0;  // block values pushed so far
  for (int s = 0; s < slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < slices) {
      stage(s + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int k0 = s * SLICE;
    const int halves = min(SLICE, K - k0) / HALF;  // 8 | K: 1 or 2
#pragma unroll 1
    for (int h = 0; h < halves; ++h) {
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        int32_t a[TM];
        int32_t b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[buf][h * HALF + q][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[buf][h * HALF + q][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i * TN + j] = qk::wadd(acc[i * TN + j], qk::wmul(a[i], b[j]));
          }
        }
      }
      if (((k0 + (h + 1) * HALF) & bmask) == 0) {  // a block ends: push
        hybrid_shift(acc, p.dl);
        hybrid_push<qk::ANY, qk::ANY, true>(slot, acc, 0, t, p.fold);
#pragma unroll
        for (int o = 0; o < OUTS; ++o) acc[o] = 0;
        ++t;
      }
    }
    __syncthreads();  // buf is refilled by the next iteration's copies
  }

  int32_t res[OUTS];
  hybrid_drain<true>(slot, res, p);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (r < M && c < N) {
        qk::store_lane(C, (size_t)r * N + c, res[i * TN + j], out_bytes);
      }
    }
  }
}

}  // namespace

// K2h's IMAD kernel on int32 A [m, k] and B [k, n], C [m, n] in out_bytes
// lanes; params as read_hybrid reads them.  Returns a cudaError_t, or -1
// for arguments outside the kernel's range.
extern "C" int qk_tree_gemm_hybrid(int device, const void* a, const void* b,
                                   void* c, int m, int n, int k,
                                   int out_bytes, const int* params,
                                   void* stream) {
  HybridParams p{};
  int levels;
  if (!read_hybrid(params, m, n, k, out_bytes, &p, &levels)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 16 * TN - 1) / (16 * TN),
                  (m + 16 * TM - 1) / (16 * TM));
  tree_gemm_hybrid_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), c, m,
      n, k, out_bytes, p);
  return (int)cudaGetLastError();
}
