// G1: an elementwise product of int8 lanes requantized twice into an int8
// lane, out = fin(mid(a * b)), as qcast(qmul(a, b, to=mid), fin) computes
// it (qublas_tpu_torch/moe.py: a SwiGLU expert's h = (g * u -> Qu<7,8>)
// cast to Qu<3,4>), in one pass over a, b and out where the elementwise
// ops make nine over int32 copies.  mid truncates and saturates (Step), so
// its result fits its lane and needs no wrap; fin is a requantize step in
// any mode (requant.cuh).
//
// What bounds it: bytes.  A thread takes 16 adjacent elements: a 16-byte
// load of each input, a 16-byte store.  The wrapper (ops/library.py)
// launches it for such steps, int8 lanes, a multiple of 16 elements and
// 16-byte aligned tensors.

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;

// A requantize step that truncates (TRN_TCPL, or no fraction bit dropped)
// and then saturates into [lo, hi] (zero: to 0 outside it).
struct Step {
  int d;
  int32_t lo, hi;
  int zero;
};

struct Steps {
  Step mid;
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

__global__ void __launch_bounds__(THREADS)
mul_requant_s8_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                      int4* __restrict__ out, long long vecs,
                      const __grid_constant__ Steps st) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= vecs) return;
  const int4 va = __ldg(a + i), vb = __ldg(b + i);
  const uint32_t wa[4] = {(uint32_t)va.x, (uint32_t)va.y, (uint32_t)va.z,
                          (uint32_t)va.w};
  const uint32_t wb[4] = {(uint32_t)vb.x, (uint32_t)vb.y, (uint32_t)vb.z,
                          (uint32_t)vb.w};
  uint32_t wo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t x = (int8_t)(wa[q] >> (8 * j));
      const int32_t y = (int8_t)(wb[q] >> (8 * j));
      const int32_t v = qk::requant(step(x * y, st.mid), st.fin);
      packed |= ((uint32_t)v & 0xffu) << (8 * j);
    }
    wo[q] = packed;
  }
  out[i] = make_int4((int)wo[0], (int)wo[1], (int)wo[2], (int)wo[3]);
}

}  // namespace

// a, b and out [n] int8 (16-byte aligned, n a multiple of 16); steps: mid
// in four ints (shift, lo, hi, zero), then fin in five (shift, round,
// overflow, width, signedness).  Returns a cudaError_t,
// -1 for arguments outside the kernel's range.
extern "C" int qk_mul_requant(int device, const void* a, const void* b,
                              void* out, long long n, const int* steps,
                              void* stream) {
  if (n < 0 || n % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Steps st;
  st.mid = Step{steps[0], steps[1], steps[2], steps[3]};
  st.fin = qk::Rq{steps[4], steps[5], steps[6], steps[7], steps[8]};
  const long long vecs = n / 16;
  mul_requant_s8_kernel<<<(unsigned)((vecs + THREADS - 1) / THREADS),
                          THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<int4*>(out), vecs, st);
  return (int)cudaGetLastError();
}
