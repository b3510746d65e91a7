// C1: the combine of a mixture-of-experts layer (qublas_tpu_torch/moe.py):
// each row's output from the shared expert's and its routed experts'
// outputs,
//
//   acc[r, c] = sat(sh(shared[r, c])
//                   + sum_k pacc(pair(w[r, k] * d[pos[r, k], c])))
//   out[r, c] = fin(acc[r, c])
//
// over the slots k whose expert is held here (pos[r, k] >= 0: the row of d,
// the held experts' outputs in dispatch order, that holds the pair), each
// of pair, pacc, sh and sat a step that truncates and saturates (Step), fin
// a requantize step in any mode (requant.cuh).  The sum wraps in int32 as torch's index_add_ does; moe.py calls
// it where every product fits int32 and no sum leaves int32, so the order
// of the adds cannot show.  In place of a scatter-add over the pairs
// (passes over an int32 [pairs, n] tensor and atomics into [rows, n]) it is
// one gather a row: shared and d read once, out written once.
//
// What bounds it: bytes.  A block takes one row and THREADS * 8 of its
// columns, a thread 8 adjacent int16 columns: one 16-byte load of shared
// and of each held slot's row of d, all in flight together.  The wrapper
// (ops/library.py) launches it for int16 lanes, n a multiple of 8 and at
// most MAX_K slots.

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 8;  // routed slots a row, at most

// A requantize step that truncates (TRN_TCPL, or no fraction bit dropped)
// and then saturates into [lo, hi] (zero: to 0 outside it): qk::requant's
// result for those modes in a few instructions.
struct Step {
  int d;
  int32_t lo, hi;
  int zero;
};

// pair, pacc, sh, sat; fin
struct Steps {
  Step s[4];
  qk::Rq fin;
};

__device__ __forceinline__ int32_t step(int32_t x, const Step& f) {
  const int32_t y = f.d > 0 ? qk::sar(x, f.d) : qk::shl(x, -f.d);
  if (f.zero) {
    return ((uint32_t)y - (uint32_t)f.lo) > ((uint32_t)f.hi - (uint32_t)f.lo)
               ? 0 : y;
  }
  return y < f.lo ? f.lo : (y > f.hi ? f.hi : y);
}

// Eight int16 lanes from 16 bytes.
__device__ __forceinline__ void unpack8(const int4& v, int32_t (&x)[8]) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = (int32_t)(int16_t)(w[i] & 0xffffu);
    x[2 * i + 1] = (int32_t)(int16_t)(w[i] >> 16);
  }
}

__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const int16_t* __restrict__ shared,
                   const int16_t* __restrict__ d,
                   const int32_t* __restrict__ pos,
                   const int32_t* __restrict__ w, void* __restrict__ out,
                   int n, int k, int out_bytes,
                   const __grid_constant__ Steps st) {
  // the row's slots: -1 where the slot's expert is not held here
  __shared__ int32_t rows[MAX_K];
  __shared__ int32_t ws[MAX_K];
  const long long r = blockIdx.x;
  if (threadIdx.x < k) {
    rows[threadIdx.x] = pos[r * k + threadIdx.x];
    ws[threadIdx.x] = w[r * k + threadIdx.x];
  }
  __syncthreads();
  const int c = (blockIdx.y * THREADS + threadIdx.x) * 8;
  if (c >= n) return;
  int32_t acc[8], v[8];
  unpack8(__ldg(reinterpret_cast<const int4*>(shared + r * n + c)), acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = step(acc[j], st.s[2]);
  int4 dv[MAX_K];
#pragma unroll
  for (int s = 0; s < MAX_K; ++s) {
    if (s < k && rows[s] >= 0) {
      dv[s] = __ldg(
          reinterpret_cast<const int4*>(d + (long long)rows[s] * n + c));
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_K; ++s) {
    if (s < k && rows[s] >= 0) {
      unpack8(dv[s], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] = qk::wadd(
            acc[j], step(step(qk::wmul(ws[s], v[j]), st.s[0]), st.s[1]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qk::store_lane(out, r * n + c + j,
                   qk::requant(step(acc[j], st.s[3]), st.fin), out_bytes);
  }
}

}  // namespace

// shared [rows, n] and d [*, n] int16 (contiguous, 16-byte aligned, n a
// multiple of 8), pos and w [rows, k] int32 (k <= MAX_K), out [rows, n]
// (out_bytes lanes); steps: pair, pacc, sh and sat, four ints each (shift,
// lo, hi, zero), then fin in five (shift, round, overflow, width,
// signedness).  Returns a cudaError_t, -1 for arguments outside
// the kernel's range.
extern "C" int qk_moe_combine(int device, const void* shared, const void* d,
                              const void* pos, const void* w, void* out,
                              int rows, int n, int k, int out_bytes,
                              const int* steps, void* stream) {
  if (k < 0 || k > MAX_K || rows < 0 || n < 0 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(shared) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d) % 16 != 0) {
    return -1;
  }
  if (rows == 0 || n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Steps st;
  for (int i = 0; i < 4; ++i) {
    const int* p = steps + 4 * i;
    st.s[i] = Step{p[0], p[1], p[2], p[3]};
  }
  const int* p = steps + 16;
  st.fin = qk::Rq{p[0], p[1], p[2], p[3], p[4]};
  const dim3 grid(rows, (n + THREADS * 8 - 1) / (THREADS * 8));
  moe_combine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(shared), static_cast<const int16_t*>(d),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(w), out,
      n, k, out_bytes, st);
  return (int)cudaGetLastError();
}
