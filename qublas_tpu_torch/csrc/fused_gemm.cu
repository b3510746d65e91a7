// K1: integer GEMM with int32 accumulation and the requantize fused on the
// accumulator, for qgemul's lossless tier.
//
// Replaces the Pallas kernel qublas_tpu/ops/pallas_gemm.py:_pallas_gemm
// (body _epilogue_kernel): there the sequential K grid axis carries the
// int32 accumulator in VMEM scratch and the last K step runs
// requantize_i32 and stores the narrow lane.  On Hopper blocks run in no
// order, so the K loop moves inside the block and the accumulator lives in
// registers; the epilogue (csrc/requant.cuh) runs on those registers and
// writes int8/int16/int32 once.  Valid only under ops/gemm.exact_plan's
// proof: every partial sum fits int32, so any summation order is exact.
//
// What bounds it on the H100: int8 tensor-core operations.  At 4096^3 the
// GEMM is 137 G int8 ops against 48 MB of operand and output traffic,
// far above the ridge point.  This first version issues mma.sync
// m16n8k32 (IMMA) from shared-memory tiles loaded by plain vector loads,
// with one tile buffer and no cp.async/TMA pipeline, so it is bound by the
// tile loads and block synchronisation, not the tensor cores; wgmma, TMA
// and multi-stage buffering are later work.
//
// Two instantiations, as qublas_tpu/ops/pallas_gemm.py:qgemul_fast casts:
//  * int8 operands: tensor cores; B arrives transposed ([N, K], K
//    contiguous) so both tiles load along K;
//  * int32 operands (int16/int32 lanes): a shared-memory tiled SIMT GEMM
//    with wrapping int32 multiply-add.
// Both take any M, N, K and mask the ragged edges.

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // 80-byte rows: fragment loads hit 32 banks
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N

// Copy 16 bytes of row `row`, columns [col, col + 16), of a rows x cols
// int8 matrix into shared memory, zero-filling outside the matrix.
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* src,
                                       int row, int col, int rows, int cols,
                                       bool vec) {
  if (vec && row < rows && col + 16 <= cols) {
    *reinterpret_cast<int4*>(dst) = __ldg(
        reinterpret_cast<const int4*>(src + (size_t)row * cols + col));
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    dst[e] = (row < rows && col + e < cols) ? src[(size_t)row * cols + col + e]
                                            : (int8_t)0;
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The epilogue's requantize, kept out of line: inlined into the 64
// unrolled accumulator stores, its mode branches are unswitched into a
// code size that ptxas takes many minutes over.
__device__ __noinline__ int32_t epilogue(int32_t x, qk::Rq rq) {
  return qk::requant(x, rq);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// C[m, n] = requant(sum_k A[m, k] * Bt[n, k]); A [M, K], Bt [N, K] int8.
__global__ void __launch_bounds__(THREADS)
fused_gemm_s8_kernel(const int8_t* __restrict__ A,
                     const int8_t* __restrict__ Bt, void* __restrict__ C,
                     int M, int N, int K, int out_bytes, bool vec,
                     qk::Rq rq) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;   // 0..1: 64-row slab
  const int wn = warp & 3;    // 0..3: 32-column slab
  const int g = lane >> 2;    // mma groupID
  const int tg = lane & 3;    // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16);
      const int kc = (c % (BK / 16)) * 16;
      load16(As + r * LDS + kc, A, m0 + r, k0 + kc, M, K, vec);
      load16(Bs + r * LDS + kc, Bt, n0 + r, k0 + kc, N, K, vec);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = As + (wm * 64 + mi * 16 + g) * LDS + ks + 4 * tg;
        const int8_t* r8 = r0 + 8 * LDS;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r8);
        af[mi][2] = lds32(r0 + 16);
        af[mi][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + 4 * tg;
        bf[ni][0] = lds32(c0);
        bf[ni][1] = lds32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // fused epilogue on the accumulator registers
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + wm * 64 + mi * 16 + g;
      const int c = n0 + wn * 32 + ni * 8 + 2 * tg;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8;
        const int cc = c + (e & 1);
        if (rr < M && cc < N) {
          qk::store_lane(C, (size_t)rr * N + cc, epilogue(acc[mi][ni][e], rq),
                         out_bytes);
        }
      }
    }
  }
}

constexpr int TS = 16;  // SIMT tile: 16 x 16 outputs, 16-deep K slices

// C[m, n] = requant(sum_k A[m, k] * B[k, n]); A [M, K], B [K, N] int32.
__global__ void __launch_bounds__(TS * TS)
fused_gemm_s32_kernel(const int32_t* __restrict__ A,
                      const int32_t* __restrict__ B, void* __restrict__ C,
                      int M, int N, int K, int out_bytes, qk::Rq rq) {
  __shared__ int32_t As[TS][TS + 1];
  __shared__ int32_t Bs[TS][TS + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * TS + ty;
  const int col = blockIdx.x * TS + tx;
  int32_t acc = 0;
  for (int k0 = 0; k0 < K; k0 += TS) {
    As[ty][tx] = (row < M && k0 + tx < K) ? A[(size_t)row * K + k0 + tx] : 0;
    Bs[ty][tx] = (k0 + ty < K && col < N) ? B[(size_t)(k0 + ty) * N + col] : 0;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < TS; ++e) acc = qk::wadd(acc, qk::wmul(As[ty][e], Bs[e][tx]));
    __syncthreads();
  }
  if (row < M && col < N) {
    qk::store_lane(C, (size_t)row * N + col, qk::requant(acc, rq), out_bytes);
  }
}

}  // namespace

extern "C" int qk_fused_gemm_s8(int device, const void* a, const void* bt,
                                void* c, int m, int n, int k, int out_bytes,
                                int d, int round, int ovf, int w, int sgn,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (k % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(bt) % 16 == 0);
  const qk::Rq rq{d, round, ovf, w, sgn};
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  fused_gemm_s8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt), c, m, n,
      k, out_bytes, vec, rq);
  return (int)cudaGetLastError();
}

extern "C" int qk_fused_gemm_s32(int device, const void* a, const void* b,
                                 void* c, int m, int n, int k, int out_bytes,
                                 int d, int round, int ovf, int w, int sgn,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const qk::Rq rq{d, round, ovf, w, sgn};
  dim3 grid((n + TS - 1) / TS, (m + TS - 1) / TS);
  fused_gemm_s32_kernel<<<grid, dim3(TS, TS), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), c, m, n,
      k, out_bytes, rq);
  return (int)cudaGetLastError();
}
