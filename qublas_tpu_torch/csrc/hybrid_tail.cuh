// The hybrid tier's tail, beside K2h's tensor-core kernels
// (tree_gemm_hybrid_mma.cuh, on every lane width) and the experiments'
// variants of them: the plan's parameters and their reader, the shift of a
// block value to tree level L, the push of a value onto the binary-carry
// slot stack of tree levels L and up, and the drain over the k / s block
// values.
//
// A kernel keeps its slots where it likes (local memory, registers, shared
// memory) behind an accessor with get(o, l) and set(o, l, v): output o's
// slot of stack level l, tree level L + l.
#pragma once

#include "tree_gemm.cuh"

namespace qk {

// The hybrid plan as the kernels read it (read_hybrid): the block size
// s = 2^level, the shift dl of a block dot to tree level `level`, and the
// tail's steps with tree level `level + j` as the fold's level j.
struct HybridParams {
  int level;
  int dl;
  Fold fold;
  Rq fin;  // final_fmt -> out_fmt
};

// K2h's least block: 2^3 products, the half fragment (k 0..7 or 8..15) of
// the tensor-core kernel's m16n8k16.
constexpr int HYB_MIN_LEVEL = 3;

// params (host int32), as qublas_tpu_torch/ops/tree_gemm.py:_hybrid_params
// writes them: level, dl, levels, merge[levels][5], ndrain,
// (op, level)[ndrain], fin[5].  Returns false outside the kernels' range:
// a level below HYB_MIN_LEVEL, a k that s does not divide, a stack depth
// other than bit_length(k / s), an output lane other than 1, 2 or 4 bytes.
inline bool read_hybrid(const int* params, int m, int n, int k, int out_bytes,
                 HybridParams* p, int* levels) {
  p->level = params[0];
  p->dl = params[1];
  *levels = params[2];
  const int* q = read_fold(params + 2, &p->fold);
  if (q == nullptr || p->level < HYB_MIN_LEVEL || p->level > 30 ||
      p->dl < 0 || p->dl > 31 || k < 1 || m < 1 || n < 1 ||
      (k & ((1 << p->level) - 1)) != 0 ||
      *levels != bit_length(k >> p->level) ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4)) {
    return false;
  }
  p->fin = read_rq(q);
  return true;
}

// A requantize whose modes are read at run time, out of line: inlined at
// every merge of every output, its mode dispatch multiplied the kernels'
// code, and their build time, many times over.  Static: each source that
// includes this keeps its own copy.
static __device__ __noinline__ int32_t requant_rt(int32_t x, Rq r) {
  return requant(x, r);
}

// The requantize of a step whose modes RND and OVF are fixed at compile
// time (with_modes), inlined; out of line where either is read at run time
// (ANY).
template <int RND, int OVF>
__device__ __forceinline__ int32_t requant_modes(int32_t x, const Rq& r) {
  if constexpr (RND == ANY || OVF == ANY) {
    return requant_rt(x, with_modes<RND, OVF>(r));
  } else {
    return requant(x, with_modes<RND, OVF>(r));
  }
}

// A block's exact dot at tree level `level`: shifted left by dl <= 31.
template <int OUTS>
__device__ __forceinline__ void hybrid_shift(int32_t (&v)[OUTS], int dl) {
#pragma unroll
  for (int o = 0; o < OUTS; ++o) v[o] = (int32_t)((uint32_t)v[o] << dl);
}

// Push the values v of stack level `base` (tree level L + base) onto the
// slot stack, t values of that level pushed before them: one merge per
// trailing one-bit of t, the slot the earlier, left operand (tree_fold.cuh's
// push), in a rolled loop; then the store.  v holds the result.  RND, OVF:
// the merges' modes fixed at compile time (with_modes), or ANY.
template <int RND = ANY, int OVF = ANY, int OUTS, class Slots>
__device__ __forceinline__ void hybrid_push(Slots& s, int32_t (&v)[OUTS],
                                            int base, int t, const Fold& f) {
  const int top = base + __ffs(~t) - 1;
#pragma unroll 1
  for (int l = base; l < top; ++l) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      v[o] = requant_modes<RND, OVF>(wadd(s.get(o, l), v[o]), f.merge[l]);
    }
  }
#pragma unroll
  for (int o = 0; o < OUTS; ++o) s.set(o, top, v[o]);
}

// The drain (tree_fold.cuh's, the levels offset by L) over the stack: the
// tail's odd edges, then the final requantize, once an output, their modes
// read at run time, out of line.  Every slot it reads was written by a
// push: drain_ops reads only the levels of the block count's one-bits.
template <int OUTS, class Slots>
__device__ __forceinline__ void hybrid_drain(const Slots& s,
                                             int32_t (&out)[OUTS],
                                             const HybridParams& p) {
  const Fold& f = p.fold;
#pragma unroll
  for (int o = 0; o < OUTS; ++o) out[o] = 0;
  for (int d = 0; d < f.ndrain; ++d) {
    const int l = f.drain_lvl[d];
    const int op = f.drain_op[d];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      if (op == CONVERT) {
        out[o] = requant_rt(out[o], f.merge[l]);
      } else {
        out[o] = op == SEED ? s.get(o, l)
                            : requant_rt(wadd(s.get(o, l), out[o]),
                                         f.merge[l]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < OUTS; ++o) out[o] = requant_rt(out[o], p.fin);
}

}  // namespace qk

namespace {
using qk::HYB_MIN_LEVEL;
using qk::hybrid_drain;
using qk::hybrid_push;
using qk::hybrid_shift;
using qk::HybridParams;
using qk::read_hybrid;
using qk::requant_modes;
}  // namespace
