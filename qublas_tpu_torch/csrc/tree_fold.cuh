// The reference's balanced tree (QuBLAS.h:4960-4990) evaluated in one pass
// per output element, shared by the tree GEMM (tree_gemm.cu: K2, K2') and
// the tree reduce (qreduce.cu: K3).  The schedule is
// qublas_tpu/ops/tree_gemm.py:tree_gemm_scan's, proven there for any
// length n:
//   * leaves come in blocks of BLK = 2^LOG_BLK, BLK dividing n; a block is
//     folded through tree layers 0 .. LOG_BLK-1 in registers (fold_block);
//   * block values go onto a binary-carry slot stack, slot l holding a
//     partial of tree level LOG_BLK + l: pushing block t merges once per
//     trailing one-bit of t (push);
//   * the planner's drain ops (seed / convert / add) finish the ragged
//     right edge, where the reference's odd tails are (drain).
// Every merge is the layer's Qadd: the two values of one level added
// (left operand first) and requantized into the layer's format.
//
// The stack is an array with a compile-time size touched only at static
// indices (unrolled loops, select-by-compare), so it stays in registers.
#pragma once

#include <cstdint>

#include "requant.cuh"

namespace qk {

constexpr int MAXL = 32;  // tree levels: n < 2^31

// A mode read at run time from Rq, in the instantiations of K2 and K3.
constexpr int ANY = -1;

// The requantize step p with its round and overflow modes fixed to RND
// and OVF (ANY: p's own): requant's mode dispatch then folds away at
// compile time, and the shared requant.cuh stays as K2', K3 and P1 use it.
template <int RND, int OVF>
__device__ __forceinline__ Rq with_modes(Rq p) {
  if constexpr (RND != ANY) p.round = RND;
  if constexpr (OVF != ANY) p.ovf = OVF;
  return p;
}

enum FoldOp : int { SEED = 0, CONVERT = 1, ADD = 2 };

// The tree's requantize steps and drain schedule, as the Python planners
// write them (read_fold).
struct Fold {
  Rq merge[MAXL];  // layer l: level_fmts[l] -> merge_fmts[l]
  int ndrain;
  int drain_op[2 * MAXL];
  int drain_lvl[2 * MAXL];
};

__device__ __forceinline__ int32_t merge(const Fold& f, int l, int32_t left,
                                         int32_t right) {
  return requant(wadd(left, right), f.merge[l]);
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

// Tree layers 0 .. LOG_BLK-1 over one block of leaves; returns its value.
template <int LOG_BLK>
__device__ __forceinline__ int32_t fold_block(int32_t (&v)[1 << LOG_BLK],
                                              const Fold& f) {
#pragma unroll
  for (int l = 0; l < LOG_BLK; ++l) {
#pragma unroll
    for (int q = 0; q < ((1 << LOG_BLK) >> (l + 1)); ++q) {
      v[q] = merge(f, l, v[2 * q], v[2 * q + 1]);
    }
  }
  return v[0];
}

// Push the value of block t: merge with the slot of each trailing one-bit
// of t (the slot is the earlier, left operand), then store.
template <int LOG_BLK, int TOP>
__device__ __forceinline__ void push(int32_t (&slot)[TOP], int t,
                                     int32_t val, const Fold& f) {
  const int cnt = __ffs(~t) - 1;
#pragma unroll
  for (int l = 0; l < TOP; ++l) {
    if (LOG_BLK + l < MAXL && l < cnt) {
      val = merge(f, LOG_BLK + l, slot[l], val);
    }
  }
#pragma unroll
  for (int l = 0; l < TOP; ++l) {
    if (l == cnt) slot[l] = val;
  }
}

// Run the drain schedule (qublas_tpu/ops/tree_gemm.py:_drain) over the
// stack; returns the tree's value in its final format.
template <int LOG_BLK, int TOP>
__device__ __forceinline__ int32_t drain(const int32_t (&slot)[TOP],
                                         const Fold& f) {
  int32_t carry = 0;
  for (int s = 0; s < f.ndrain; ++s) {
    const int l = f.drain_lvl[s];
    if (f.drain_op[s] == CONVERT) {
      carry = requant(carry, f.merge[l]);
      continue;
    }
    const int32_t sv = pick(slot, l > LOG_BLK ? l - LOG_BLK : 0);
    carry = f.drain_op[s] == SEED ? sv : merge(f, l, sv, carry);
  }
  return carry;
}

inline Rq read_rq(const int* q) { return Rq{q[0], q[1], q[2], q[3], q[4]}; }

// Read levels, merge[levels][5], ndrain, (op, level)[ndrain] from the host
// parameter array into f.  Returns the position after them, or nullptr for
// parameters outside the kernels' range.
inline const int* read_fold(const int* q, Fold* f) {
  const int levels = *q++;
  if (levels < 1 || levels > MAXL) return nullptr;
  for (int l = 0; l < levels; ++l, q += 5) f->merge[l] = read_rq(q);
  f->ndrain = *q++;
  if (f->ndrain < 0 || f->ndrain > 2 * MAXL) return nullptr;
  for (int s = 0; s < f->ndrain; ++s) {
    f->drain_op[s] = *q++;
    f->drain_lvl[s] = *q++;
    if (f->drain_lvl[s] < 0 || f->drain_lvl[s] >= levels) return nullptr;
  }
  return q;
}

}  // namespace qk
