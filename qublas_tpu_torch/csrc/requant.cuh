// Bit-exact requantize of int32 values: the device copy of
// qublas_tpu_torch/ops/wideint.py, itself the port of
// qublas_tpu/ops/wideint.py:335-465 (_carry_mode, _overflow_i32,
// requantize_i32, requantize_split_mul).  Shared by both kernels.
//
// Shifts and wrapping arithmetic go through uint32_t: in C++17 a left shift
// of a negative int, or a signed overflow, is undefined; the JAX lanes and
// torch both wrap.  A right shift of a negative int32_t is arithmetic in
// nvcc, as in XLA and torch.
#pragma once

#include <cstdint>

namespace qk {

// RoundMode / OverflowMode values of qublas_tpu/qformat.py
enum Round : int {
  RND_POS_INF = 0, RND_NEG_INF = 1, RND_ZERO = 2, RND_INF = 3, RND_CONV = 4,
  TRN_TCPL = 5, TRN_SMGN = 6
};
enum Ovf : int {
  SAT_TCPL = 0, SAT_ZERO = 1, SAT_SMGN = 2, WRP_TCPL = 3, WRP_TCPL_SAT = 4
};

// One requantize step: from_frac - to_frac, the destination's modes, its
// storage width (1 + int_bits + frac_bits) and signedness.
struct Rq {
  int d;
  int round;
  int ovf;
  int w;
  int sgn;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int32_t shl(int32_t x, int s) {
  return s >= 32 ? 0 : (int32_t)((uint32_t)x << s);
}

__device__ __forceinline__ int32_t sar(int32_t x, int s) {
  return x >> (s > 31 ? 31 : s);
}

__device__ __forceinline__ bool carry_mode(int mode, bool gt, bool ge,
                                           bool eq, bool neg, bool pos,
                                           bool odd) {
  switch (mode) {
    case RND_POS_INF: return ge;
    case RND_NEG_INF: return gt;
    case RND_ZERO: return gt || (eq && neg);
    case RND_INF: return gt || (eq && pos);
    default: return gt || (eq && odd);  // RND_CONV
  }
}

__device__ __forceinline__ int32_t overflow_i32(int32_t y, const Rq& p) {
  const int w = p.w;
  if (p.ovf == SAT_TCPL || p.ovf == SAT_ZERO || p.ovf == SAT_SMGN) {
    if (w > 32) return y;
    const int32_t hi = (int32_t)((1u << (w - 1)) - 1u);
    int32_t lo;
    if (!p.sgn) lo = 0;
    else if (p.ovf == SAT_SMGN) lo = -hi;
    else lo = (int32_t)(~(uint32_t)hi);  // -(2^(w-1))
    if (p.ovf == SAT_ZERO) {
      // one unsigned range compare: y outside [lo, hi]
      return ((uint32_t)y - (uint32_t)lo) > ((uint32_t)hi - (uint32_t)lo)
                 ? 0 : y;
    }
    return y < lo ? lo : (y > hi ? hi : y);
  }
  if (p.ovf == WRP_TCPL) {
    if (p.sgn) {
      if (w >= 32) return y;
      const uint32_t mask = (1u << w) - 1u;
      const uint32_t m = (uint32_t)y & mask;
      return (int32_t)(((m >> (w - 1)) & 1u) ? (m | ~mask) : m);
    }
    const int wb = w - 1;  // unsigned wrap masks to int_bits + frac_bits
    if (wb >= 32) return y;
    return (int32_t)((uint32_t)y & ((1u << wb) - 1u));
  }
  return y;  // WRP_TCPL_SAT: the reference's identity stub
}

// requantize_i32: round x (at from_frac) to the destination, then overflow.
__device__ __forceinline__ int32_t requant(int32_t x, const Rq& p) {
  const int d = p.d;
  int32_t y;
  if (d <= 0) {
    y = shl(x, -d);
  } else if (p.round == TRN_TCPL) {
    y = sar(x, d);
  } else if (p.round == TRN_SMGN) {
    // truncate toward zero by bias-add (no negation of INT32_MIN)
    const int32_t bias = x < 0 ? (int32_t)((1u << d) - 1u) : 0;
    y = sar(wadd(x, bias), d);
  } else {
    // d <= 31 on the i32 route (widths.route_requant)
    const int32_t xh = sar(x, d);
    const int32_t xl = (int32_t)((uint32_t)x & ((1u << d) - 1u));
    const int32_t t = (int32_t)(1u << (d - 1));
    const bool c = carry_mode(p.round, xl > t, xl >= t, xl == t, x < 0,
                              x > 0, (xh & 1) != 0);
    y = wadd(xh, c ? 1 : 0);
  }
  return overflow_i32(y, p);
}

// requantize_split_mul: requantized a * b for products wider than int32,
// with 1 <= d <= 30 (widths.split_mul_ok).
__device__ __forceinline__ int32_t requant_split_mul(int32_t a, int32_t b,
                                                     const Rq& p) {
  const int d = p.d;
  const uint32_t mask = (1u << d) - 1u;
  const int32_t bl = (int32_t)((uint32_t)b & mask);
  const int32_t bh = sar(b, d);
  const int32_t albl = wmul(a, bl);
  const int32_t xh = wadd(wmul(a, bh), sar(albl, d));  // floor(prod / 2^d)
  int32_t y;
  if (p.round == TRN_TCPL) {
    y = xh;
  } else {
    const int32_t xl = (int32_t)((uint32_t)albl & mask);
    if (p.round == TRN_SMGN) {
      const bool neg = ((a ^ b) < 0) && a != 0;
      y = wadd(xh, (neg && xl != 0) ? 1 : 0);
    } else {
      const int32_t t = (int32_t)(1u << (d - 1));
      const bool nz = a != 0 && b != 0;
      const bool c = carry_mode(p.round, xl > t, xl >= t, xl == t,
                                ((a ^ b) < 0) && nz, ((a ^ b) >= 0) && nz,
                                (xh & 1) != 0);
      y = wadd(xh, c ? 1 : 0);
    }
  }
  return overflow_i32(y, p);
}

// Store an int32 result into the output lane (int8/int16/int32), wrapping
// like torch's and JAX's integer casts.
__device__ __forceinline__ void store_lane(void* out, size_t idx, int32_t v,
                                           int out_bytes) {
  if (out_bytes == 1) {
    static_cast<int8_t*>(out)[idx] = (int8_t)v;
  } else if (out_bytes == 2) {
    static_cast<int16_t*>(out)[idx] = (int16_t)v;
  } else {
    static_cast<int32_t*>(out)[idx] = v;
  }
}

}  // namespace qk
