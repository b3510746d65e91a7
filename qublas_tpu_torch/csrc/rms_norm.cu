// N1: RMSNorm of int8 rows through a ROM of each row's sum of squares, as
// qublas_tpu_torch/moe.py's rms_norm computes it with the elementwise ops
// and a QTable (a DeepSeek-V3 layer's norm before its router and experts):
//
//   ss        = sum_c x[r, c]^2            exact in int32
//   rs        = table[cast(ss) & mask]     the rsqrt ROM
//   s         = scale(rs * gain)           the row's factor
//   out[r, c] = fin(x[r, c] * s)
//
// cast, scale and fin are requantize steps in any mode (requant.cuh).  In
// place of passes over int32 copies of x (the squares, their sum, the
// product, its rounding and saturation) it reads each row twice, the second
// time from L1 or L2, and writes it once.
//
// What bounds it: bytes.  A block takes one row, a thread 16 adjacent
// columns at a time: a 16-byte load, a 16-byte store.  The wrapper
// (ops/library.py) launches it for int8 lanes, n a multiple of 16 and
// 16-byte aligned rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;

// cast, scale, fin
struct Steps {
  qk::Rq s[3];
};

__device__ __forceinline__ int32_t byte_at(uint32_t w, int j) {
  return (int32_t)(int8_t)(w >> (8 * j));
}

__global__ void __launch_bounds__(THREADS)
rms_norm_s8_kernel(const int4* __restrict__ x, int4* __restrict__ out,
                   int vecs, const int32_t* __restrict__ table, int mask,
                   int32_t gain, const __grid_constant__ Steps st) {
  __shared__ int32_t part[THREADS / 32];
  __shared__ int32_t factor;
  const int4* row = x + (long long)blockIdx.x * vecs;
  int4* dst = out + (long long)blockIdx.x * vecs;
  int32_t ss = 0;
  for (int i = threadIdx.x; i < vecs; i += THREADS) {
    const int4 v = __ldg(row + i);
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                           (uint32_t)v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t b = byte_at(w[q], j);
        ss += b * b;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += part[i];
    const int32_t rs = table[qk::requant(total, st.s[0]) & mask];
    factor = qk::requant(qk::wmul(rs, gain), st.s[1]);
  }
  __syncthreads();
  const int32_t s = factor;
  for (int i = threadIdx.x; i < vecs; i += THREADS) {
    const int4 v = __ldg(row + i);
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                           (uint32_t)v.w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t y = qk::requant(byte_at(w[q], j) * s, st.s[2]);
        packed |= ((uint32_t)y & 0xffu) << (8 * j);
      }
      o[q] = packed;
    }
    dst[i] = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
  }
}

}  // namespace

// x and out [rows, n] int8 (contiguous, 16-byte aligned, n a multiple of 16
// and below 2^17, so that a row's sum of squares fits int32); table: the
// ROM's int32 entries, mask its index mask; gain: the factor's raw; steps:
// cast, scale and fin, five ints each (shift, round, overflow, width,
// signedness).  Returns a cudaError_t, -1 for arguments outside the
// kernel's range.
extern "C" int qk_rms_norm(int device, const void* x, void* out, int rows,
                           int n, const void* table, int mask, int gain,
                           const int* steps, void* stream) {
  if (rows < 0 || n < 0 || n % 16 != 0 || n >= (1 << 17) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (rows == 0 || n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Steps st;
  for (int i = 0; i < 3; ++i) {
    const int* p = steps + 5 * i;
    st.s[i] = qk::Rq{p[0], p[1], p[2], p[3], p[4]};
  }
  rms_norm_s8_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), n / 16,
      static_cast<const int32_t*>(table), mask, gain, st);
  return (int)cudaGetLastError();
}
