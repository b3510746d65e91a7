// Variants of K3's warp kernel (csrc/qreduce.cuh:qreduce_warp, included
// here) at BASELINE config 2's instantiation (int8 rows, 32 leaves a lane,
// modes of K3_MODES[1]), timed by experiments/kernel_sweeps.py (part k3v)
// to see what bounds it.  Not part of the package's kernels.

#include "qreduce.cuh"

namespace {

using qk::Fold;

enum Variant : int {
  AS_IS = 0,       // the package's kernel: xor shuffles
  ADD_ONLY = 1,    // the chunk's merges plain adds, no requantize
  NO_LOADS = 2,    // the words made in registers, no device-memory loads
  LOADS_ONLY = 3,  // the words loaded and xor-ed, no merges
  SHFL_DOWN = 4,   // the lane levels by __shfl_down_sync, lane 0's node kept
  S16 = 5,         // the package's kernel on 16 leaves a lane (one load)
};

constexpr int MODES = 1;

// qreduce.cuh's fold_leaves with plain adds (recursive like it, so that
// every level unrolls and v stays in registers).
template <int LOG, int L = 0>
__device__ __forceinline__ int32_t add_leaves(int32_t (&v)[1 << LOG]) {
  if constexpr (L == LOG) {
    return v[0];
  } else {
#pragma unroll
    for (int q = 0; q < ((1 << LOG) >> (L + 1)); ++q) {
      v[q] = qk::wadd(v[2 * q], v[2 * q + 1]);
    }
    return add_leaves<LOG, L + 1>(v);
  }
}

// Tree levels L .. L+4 across the lanes, lane i merging its node with lane
// i + 2^J's: lane 0 ends with the node over the 32 lanes, the others with
// values that are never read.
template <int L, int J = 0>
__device__ __forceinline__ int32_t fold_lanes_down(int32_t val,
                                                   const Fold& f) {
  if constexpr (J == 5) {
    return val;
  } else {
    const int32_t right = __shfl_down_sync(0xffffffffu, val, 1 << J);
    return fold_lanes_down<L, J + 1>(merge_at<MODES, L + J>(f, val, right),
                                     f);
  }
}

__device__ __forceinline__ uint4 hash_word(uint4 w) {
  const uint32_t a = 1664525u, c = 1013904223u;
  return make_uint4(w.x * a + c, w.y * a + c, w.z * a + c, w.w * a + c);
}

template <int V>
__global__ void __launch_bounds__(32 * qk::WARP_ROWS)
k3_warp(const int8_t* __restrict__ X, void* __restrict__ Y, long long outer,
        long long n, int out_bytes, const Fold f) {
  constexpr int LOG_S = V == S16 ? 4 : 5;
  constexpr int S = 1 << LOG_S;
  constexpr int LOG_C = LOG_S + 5;
  constexpr int WORDS = S / 16;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * qk::WARP_ROWS + (threadIdx.x >> 5);
  if (row >= outer) return;
  const uint4* x = reinterpret_cast<const uint4*>(X + row * n) + lane * WORDS;
  const int chunks = (int)(n >> LOG_C);

  int32_t slot[qk::WARP_TOP];
#pragma unroll
  for (int l = 0; l < qk::WARP_TOP; ++l) slot[l] = 0;
  uint32_t acc = 0;
  uint4 next[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    next[w] = V == NO_LOADS ? make_uint4((uint32_t)row, lane, w, 7) : __ldg(x + w);
  }
  for (int t = 0; t < chunks; ++t) {
    int8_t e[S];
    memcpy(e, next, S);
    if (t + 1 < chunks) {
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        next[w] = V == NO_LOADS
                      ? hash_word(next[w])
                      : __ldg(x + ((long long)(t + 1) << 5) * WORDS + w);
      }
    }
    if constexpr (V == LOADS_ONLY) {
      uint32_t words[S / 4];
      memcpy(words, e, S);
#pragma unroll
      for (int q = 0; q < S / 4; ++q) acc ^= words[q];
      continue;
    }
    int32_t v[S];
#pragma unroll
    for (int q = 0; q < S; ++q) v[q] = e[q];
    int32_t val;
    if constexpr (V == ADD_ONLY) {
      val = add_leaves<LOG_S>(v);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        val = qk::wadd(val, __shfl_xor_sync(0xffffffffu, val, 1 << j));
      }
    } else if constexpr (V == SHFL_DOWN) {
      val = fold_lanes_down<LOG_S>(fold_leaves<MODES, LOG_S>(v, f), f);
    } else {
      val = fold_lanes<MODES, LOG_S>(fold_leaves<MODES, LOG_S>(v, f), lane,
                                     f);
    }
    push_at<LOG_C, qk::WARP_TOP, MODES, false>(slot, t, val, f);
  }
  int32_t r = qk::drain<LOG_C, qk::WARP_TOP>(slot, f);
  if constexpr (V == LOADS_ONLY) {
#pragma unroll
    for (int j = 0; j < 5; ++j) acc ^= __shfl_xor_sync(0xffffffffu, acc, 1 << j);
    r ^= (int32_t)acc;
  }
  if (lane == 0) qk::store_lane(Y, row, r, out_bytes);
}

template <int V>
void launch(const void* x, void* y, long long outer, long long n,
            int out_bytes, const Fold& f) {
  const unsigned grid = (unsigned)((outer + qk::WARP_ROWS - 1) / qk::WARP_ROWS);
  k3_warp<V><<<grid, 32 * qk::WARP_ROWS>>>(static_cast<const int8_t*>(x), y,
                                           outer, n, out_bytes, f);
}

}  // namespace

// x: int8 [outer, n], 1024 | n, fewer than 256 chunks of 1024, base
// 16-byte aligned; params as ops/reduce.py:ReducePlan.kernel_params writes them for
// a plan of K3_MODES[1] (the caller checks it).  Returns a cudaError_t, or
// -1 for arguments outside the variants' range.
extern "C" int k3_warp_variant(int variant, const void* x, void* y,
                               long long outer, long long n, int out_bytes,
                               const int* params) {
  Fold f{};
  if (qk::read_fold(params + 1, &f) == nullptr || n % 1024 != 0 ||
      (n >> 10) >= 256 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return -1;
  }
  switch (variant) {
    case AS_IS: launch<AS_IS>(x, y, outer, n, out_bytes, f); break;
    case ADD_ONLY: launch<ADD_ONLY>(x, y, outer, n, out_bytes, f); break;
    case NO_LOADS: launch<NO_LOADS>(x, y, outer, n, out_bytes, f); break;
    case LOADS_ONLY: launch<LOADS_ONLY>(x, y, outer, n, out_bytes, f); break;
    case SHFL_DOWN: launch<SHFL_DOWN>(x, y, outer, n, out_bytes, f); break;
    case S16: launch<S16>(x, y, outer, n, out_bytes, f); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
