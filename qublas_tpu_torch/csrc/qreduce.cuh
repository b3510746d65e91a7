// K3's kernel templates (qreduce.cu has the notes) and their launchers
// qk::launch_warp and qk::launch_cols, whose instantiations compile in
// sources of their own so that nvcc builds them in parallel:
// qreduce_warp.cu (the warp-per-row kernel, modes read at run time) and
// qreduce_modes_<MODES>.cu (the main paths' shapes, modes fixed).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "requant.cuh"
#include "tree_fold.cuh"

namespace qk {

// The (round, overflow) pairs that K3 has instantiations for, by index:
// tree level 0's pair, then the pair of every level above it; 0 reads the
// modes at run time.  ops/reduce.py:K3_MODES lists the same pairs after
// entry 0.
constexpr int K3_MODES[][4] = {
    {ANY, ANY, ANY, ANY},
    {RND_CONV, SAT_ZERO, TRN_TCPL, SAT_TCPL},  // BASELINE config 2
    {TRN_TCPL, SAT_ZERO, TRN_TCPL, SAT_ZERO},  // the layered canonical GEMM
};
constexpr int K3_NMODES = sizeof(K3_MODES) / sizeof(K3_MODES[0]);

constexpr int WARP_ROWS = 8;       // warp kernel: a warp a row, 8 a block
constexpr int WARP_TOP = 8;        // its shallow stack: < 256 chunks a row
constexpr int COLS_THREADS = 256;  // columns kernel: a thread an output

// One launch's tensors: x [outer, n, inner] and y [outer, inner].
struct Shape {
  const void* x;
  void* y;
  long long outer, n, inner;
  int in_bytes, out_bytes;
};

}  // namespace qk

namespace {

using qk::Fold;

// The merge of tree level L, a compile-time constant, with the modes of
// K3_MODES[MODES] for that level.
template <int MODES, int L>
__device__ __forceinline__ int32_t merge_at(const Fold& f, int32_t left,
                                            int32_t right) {
  constexpr int P = L == 0 ? 0 : 2;
  return qk::requant(qk::wadd(left, right),
                     qk::with_modes<qk::K3_MODES[MODES][P],
                                    qk::K3_MODES[MODES][P + 1]>(f.merge[L]));
}

// The merge of a stack level l >= 1 known at run time.
template <int MODES>
__device__ __forceinline__ int32_t merge_above(const Fold& f, int l,
                                               int32_t left, int32_t right) {
  return qk::requant(qk::wadd(left, right),
                     qk::with_modes<qk::K3_MODES[MODES][2],
                                    qk::K3_MODES[MODES][3]>(f.merge[l]));
}

// Tree levels L .. LOG-1 over the 2^LOG leaves in v, tree_fold.cuh's
// fold_block with each level a compile-time constant; returns their node.
template <int MODES, int LOG, int L = 0>
__device__ __forceinline__ int32_t fold_leaves(int32_t (&v)[1 << LOG],
                                               const Fold& f) {
  if constexpr (L == LOG) {
    return v[0];
  } else {
#pragma unroll
    for (int q = 0; q < ((1 << LOG) >> (L + 1)); ++q) {
      v[q] = merge_at<MODES, L>(f, v[2 * q], v[2 * q + 1]);
    }
    return fold_leaves<MODES, LOG, L + 1>(v, f);
  }
}

// tree_fold.cuh's push of block t's value, the stack's merges at levels
// LOG_BLK and up.  ROLLED keeps one copy of the requantize in a loop and
// reads the slots by compare-and-select (the stack is touched once a
// chunk in the warp kernel, so its code size is what counts there).
template <int LOG_BLK, int TOP, int MODES, bool ROLLED>
__device__ __forceinline__ void push_at(int32_t (&slot)[TOP], int t,
                                        int32_t val, const Fold& f) {
  static_assert(MODES == 0 || LOG_BLK >= 1, "level 0 has modes of its own");
  const int cnt = __ffs(~t) - 1;
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int l = 0; l < cnt; ++l) {
      val = merge_above<MODES>(f, LOG_BLK + l, qk::pick(slot, l), val);
    }
  } else {
#pragma unroll
    for (int l = 0; l < TOP; ++l) {
      if (LOG_BLK + l < qk::MAXL && l < cnt) {
        val = merge_above<MODES>(f, LOG_BLK + l, slot[l], val);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < TOP; ++l) {
    if (l == cnt) slot[l] = val;
  }
}

// Tree levels L .. L+4 across a warp's lanes, lane i holding a node of
// level L: at level L+J lanes i and i ^ 2^J merge, the lower lane's node
// the left operand.  Both lanes of a pair compute the same merge, so every
// lane ends with the node of level L+5 over the 32 lanes.
template <int MODES, int L, int J = 0>
__device__ __forceinline__ int32_t fold_lanes(int32_t val, int lane,
                                              const Fold& f) {
  if constexpr (J == 5) {
    return val;
  } else {
    const int32_t other = __shfl_xor_sync(0xffffffffu, val, 1 << J);
    const bool upper = (lane >> J) & 1;
    return fold_lanes<MODES, L, J + 1>(
        merge_at<MODES, L + J>(f, upper ? other : val, upper ? val : other),
        lane, f);
  }
}

// A lane's BYTES bytes of leaves: one load of up to 16 bytes, or two.
struct alignas(16) TwoWords {
  uint4 a, b;
};
template <int BYTES> struct Word;
template <> struct Word<1> { using type = unsigned char; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };
template <> struct Word<32> { using type = TwoWords; };

template <typename W>
__device__ __forceinline__ W load_word(const W* p) {
  return __ldg(p);
}
__device__ __forceinline__ TwoWords load_word(const TwoWords* p) {
  return TwoWords{__ldg(&p->a), __ldg(&p->b)};
}

// Rows of n T lanes (inner == 1), 32 * 2^LOG_S dividing n, fewer than
// 2^TOP chunks a row: one warp a row.  A chunk is 32 * S leaves, S =
// 2^LOG_S, lane i's S contiguous leaves (up to 32 bytes) read by one load,
// or two of 16 bytes (the wrapper aligns the base to the load), and
// folded through levels 0 .. LOG_S-1 in registers, then levels LOG_S ..
// LOG_S+4 across the lanes: the chunk is one node of level LOG_S+5, pushed
// onto the slot stack; the next chunk's leaves are loaded before this
// one's are folded.
template <typename T, int LOG_S, int TOP, int MODES>
__global__ void __launch_bounds__(32 * qk::WARP_ROWS)
qreduce_warp(const T* __restrict__ X, void* __restrict__ Y, long long outer,
             long long n, int out_bytes, const Fold f) {
  constexpr int S = 1 << LOG_S;
  constexpr int LOG_C = LOG_S + 5;
  using W = typename Word<S * (int)sizeof(T)>::type;
  static_assert(sizeof(W) == S * sizeof(T), "a lane's leaves");
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * qk::WARP_ROWS + (threadIdx.x >> 5);
  if (row >= outer) return;  // the whole warp
  const W* x = reinterpret_cast<const W*>(X + row * n) + lane;
  const int chunks = (int)(n >> LOG_C);

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;
  W next = load_word(x);
  for (int t = 0; t < chunks; ++t) {
    T e[S];
    memcpy(e, &next, sizeof(W));
    if (t + 1 < chunks) next = load_word(x + ((long long)(t + 1) << 5));
    int32_t v[S];
#pragma unroll
    for (int q = 0; q < S; ++q) v[q] = e[q];
    const int32_t val =
        fold_lanes<MODES, LOG_S>(fold_leaves<MODES, LOG_S>(v, f), lane, f);
    push_at<LOG_C, TOP, MODES, MODES == 0>(slot, t, val, f);
  }
  const int32_t r = qk::drain<LOG_C, TOP>(slot, f);
  if (lane == 0) qk::store_lane(Y, row, r, out_bytes);
}

// inner > 1 (e.g. the layered GEMM's [m, k, n] over k): a thread an
// output, neighbouring threads on neighbouring i, so each load of a warp
// is coalesced; blocks of 2^LOG_BLK leaves folded in registers, pushed
// onto the slot stack.
template <int LOG_BLK, int TOP, int MODES>
__global__ void __launch_bounds__(qk::COLS_THREADS)
qreduce_cols(const void* __restrict__ X, void* __restrict__ Y,
             long long outer, long long n, long long inner, int in_bytes,
             int out_bytes, const Fold f) {
  constexpr int BLK = 1 << LOG_BLK;
  const long long idx = (long long)blockIdx.x * qk::COLS_THREADS + threadIdx.x;
  if (idx >= outer * inner) return;
  const long long o = idx / inner;
  const size_t base = (size_t)o * n * inner + (size_t)(idx - o * inner);
  const int nblocks = (int)(n >> LOG_BLK);

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;
  for (int t = 0; t < nblocks; ++t) {
    int32_t v[BLK];
#pragma unroll
    for (int q = 0; q < BLK; ++q) {
      const size_t kk = ((size_t)t << LOG_BLK) + q;
      v[q] = qk::load_lane(X, base + kk * inner, in_bytes);
    }
    if constexpr (MODES == 0) {
      // tree_fold.cuh's fold and push as they are: with the run-time modes
      // fold_leaves and push_at compiled to 1.8x the time at [512]^3
      qk::push<LOG_BLK, TOP>(slot, t, qk::fold_block<LOG_BLK>(v, f), f);
    } else {
      push_at<LOG_BLK, TOP, MODES, false>(
          slot, t, fold_leaves<MODES, LOG_BLK>(v, f), f);
    }
  }
  qk::store_lane(Y, idx, qk::drain<LOG_BLK, TOP>(slot, f), out_bytes);
}

}  // namespace

namespace qk {

template <typename T, int LOG_S, int TOP, int MODES>
void launch_warp(const Shape& a, const Fold& f, cudaStream_t s) {
  const long long grid = (a.outer + WARP_ROWS - 1) / WARP_ROWS;
  qreduce_warp<T, LOG_S, TOP, MODES><<<(unsigned)grid, 32 * WARP_ROWS, 0, s>>>(
      static_cast<const T*>(a.x), a.y, a.outer, a.n, a.out_bytes, f);
}

template <int LOG_BLK, int TOP, int MODES>
void launch_cols(const Shape& a, const Fold& f, cudaStream_t s) {
  const long long grid =
      (a.outer * a.inner + COLS_THREADS - 1) / COLS_THREADS;
  qreduce_cols<LOG_BLK, TOP, MODES><<<(unsigned)grid, COLS_THREADS, 0, s>>>(
      a.x, a.y, a.outer, a.n, a.inner, a.in_bytes, a.out_bytes, f);
}

#define QK_K3_WARP(T, LOG_S, TOP, MODES)                                   \
  template void launch_warp<T, LOG_S, TOP, MODES>(const Shape&, const Fold&, \
                                                  cudaStream_t)
#define QK_K3_COLS(LOG_BLK, TOP, MODES)                                    \
  template void launch_cols<LOG_BLK, TOP, MODES>(const Shape&, const Fold&, \
                                                 cudaStream_t)

// the warp kernel with its modes read at run time (qreduce_warp.cu): every
// S whose leaves fill at most 32 bytes, both stack depths; EXT is extern
// here and empty where they are instantiated
#define QK_K3_WARP_ANY(EXT, T, LOG_S)     \
  EXT QK_K3_WARP(T, LOG_S, WARP_TOP, 0); \
  EXT QK_K3_WARP(T, LOG_S, MAXL, 0)
#define QK_K3_WARP_ALL(EXT)                                     \
  QK_K3_WARP_ANY(EXT, int8_t, 0); QK_K3_WARP_ANY(EXT, int8_t, 1);   \
  QK_K3_WARP_ANY(EXT, int8_t, 2); QK_K3_WARP_ANY(EXT, int8_t, 3);   \
  QK_K3_WARP_ANY(EXT, int8_t, 4); QK_K3_WARP_ANY(EXT, int8_t, 5);   \
  QK_K3_WARP_ANY(EXT, int16_t, 0); QK_K3_WARP_ANY(EXT, int16_t, 1); \
  QK_K3_WARP_ANY(EXT, int16_t, 2); QK_K3_WARP_ANY(EXT, int16_t, 3); \
  QK_K3_WARP_ANY(EXT, int16_t, 4); QK_K3_WARP_ANY(EXT, int32_t, 0); \
  QK_K3_WARP_ANY(EXT, int32_t, 1); QK_K3_WARP_ANY(EXT, int32_t, 2); \
  QK_K3_WARP_ANY(EXT, int32_t, 3)
QK_K3_WARP_ALL(extern);

// the main paths' shapes with their modes fixed (qreduce_modes_<M>.cu):
// int8 rows with 32 leaves a lane, and columns in blocks of 16
extern QK_K3_WARP(int8_t, 5, WARP_TOP, 1);
extern QK_K3_WARP(int8_t, 5, WARP_TOP, 2);
extern QK_K3_COLS(4, 16, 1);
extern QK_K3_COLS(4, 16, 2);

}  // namespace qk
