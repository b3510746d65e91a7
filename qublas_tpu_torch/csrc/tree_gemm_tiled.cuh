// K2's kernel template (tree_gemm_tiled.cu has the notes) and its
// launcher qk::launch_k2, whose instantiations each compile in a file of
// their own, tree_gemm_tiled_<TOP>_<modes>.cu, so that nvcc builds them in
// parallel: one takes ptxas about a minute.
#pragma once

#include <utility>

#include "tile_stage.cuh"
#include "tree_gemm.cuh"

namespace {

constexpr int LOG_BLK = 4;        // products per block and k-slice: 16
constexpr int BLK = 1 << LOG_BLK;
constexpr int TILED_THREADS = 256;  // 16 x 16, each a TM x TN micro-tile

__host__ __device__ constexpr int trailing_ones(int q) {
  return (q & 1) ? 1 + trailing_ones(q >> 1) : 0;
}

// qk::with_modes (tree_fold.cuh) fixes the modes of each step, ROUTE the
// product route: the 64-bit product alone (ROUTE_PAIR), the two int32
// routes (INT32_ROUTES) or all three (ANY) chosen at run time.  The int32
// routes keep an instantiation of their own: the 64-bit product's
// registers would push the compiled-modes kernel into spills.
template <int RND, int OVF, int ROUTE>
__device__ __forceinline__ int32_t product_modes(const TreeParams& p,
                                                 int32_t a, int32_t b) {
  const qk::Rq r = qk::with_modes<RND, OVF>(p.prod);
  if constexpr (ROUTE == qk::ROUTE_PAIR) {
    return qk::requant64((int64_t)a * b, r);
  } else if constexpr (ROUTE == qk::INT32_ROUTES) {
    return p.route != qk::ROUTE_I32 ? qk::requant_split_mul(a, b, r)
                                    : qk::requant(qk::wmul(a, b), r);
  } else {
    return qk::product_rq(p.route, a, b, r);
  }
}

template <int RND, int OVF>
__device__ __forceinline__ int32_t merge_modes(const qk::Fold& f, int l,
                                               int32_t left, int32_t right) {
  return qk::requant(qk::wadd(left, right),
                     qk::with_modes<RND, OVF>(f.merge[l]));
}

// tree_fold.cuh's push on merge_modes.
template <int TOP, int RND, int OVF>
__device__ __forceinline__ void push_modes(int32_t (&slot)[TOP], int t,
                                           int32_t val, const qk::Fold& f) {
  const int cnt = __ffs(~t) - 1;
#pragma unroll
  for (int l = 0; l < TOP; ++l) {
    if (LOG_BLK + l < qk::MAXL && l < cnt) {
      val = merge_modes<RND, OVF>(f, LOG_BLK + l, slot[l], val);
    }
  }
#pragma unroll
  for (int l = 0; l < TOP; ++l) {
    if (l == cnt) slot[l] = val;
  }
}

// f(std::integral_constant<int, Q>) for each Q, in order.
template <int... Q, class F>
__device__ __forceinline__ void for_each_q(std::integer_sequence<int, Q...>,
                                           F&& f) {
  (f(std::integral_constant<int, Q>{}), ...);
}

// Fold product v, the q-th of a slice, into one output's partials
// (levels 0-3) or, as the slice's last, onto its slot stack: q and the
// modes fixed at compile time, every merge and index static.
template <int Q, int TOP, int RND, int OVF>
__device__ __forceinline__ void fold_static(int32_t (&part)[LOG_BLK],
                                            int32_t (&slot)[TOP], int t,
                                            int32_t v, const qk::Fold& f) {
  constexpr int ONES = trailing_ones(Q);
#pragma unroll
  for (int l = 0; l < ONES; ++l) v = merge_modes<RND, OVF>(f, l, part[l], v);
  if constexpr (Q == BLK - 1) {
    push_modes<TOP, RND, OVF>(slot, t, v, f);
  } else {
    part[ONES] = v;
  }
}

// The same with q and the modes read at run time: rolled carries, the
// partials and slots picked and stored by compare-and-select.
template <int TOP>
__device__ __forceinline__ void fold_dynamic(int q, int32_t (&part)[LOG_BLK],
                                             int32_t (&slot)[TOP], int t,
                                             int32_t v, const qk::Fold& f) {
  const int ones = __popc(q & ~(q + 1));  // trailing one-bits of q
#pragma unroll 1
  for (int l = 0; l < ones; ++l) v = qk::merge(f, l, qk::pick(part, l), v);
  if (q == BLK - 1) {
    const int cnt = __ffs(~t) - 1;
#pragma unroll 1
    for (int l = 0; l < cnt; ++l) {
      v = qk::merge(f, LOG_BLK + l, qk::pick(slot, l), v);
    }
#pragma unroll
    for (int l = 0; l < TOP; ++l) {
      if (l == cnt) slot[l] = v;
    }
  } else {
#pragma unroll
    for (int l = 0; l < LOG_BLK; ++l) {
      if (l == ones) part[l] = v;
    }
  }
}

// A [M, K], B [K, N] int32 row-major; k / 16 full blocks < 2^TOP; at
// least MINB blocks of it resident on an SM.
template <int TOP, int TM, int TN, int MINB, int RND, int OVF, int ROUTE>
__global__ void __launch_bounds__(TILED_THREADS, MINB)
tree_gemm_tiled_kernel(const int32_t* __restrict__ A,
                       const int32_t* __restrict__ B, void* __restrict__ C,
                       int M, int N, int K, int out_bytes,
                       const TreeParams p) {
  constexpr int TBM = 16 * TM;   // tile rows
  constexpr int TBN = 16 * TN;   // tile columns
  constexpr int LDA = TBM + 4;   // As[k][row], 16-byte aligned rows
  constexpr int OUTS = TM * TN;
  __shared__ __align__(16) int32_t As[2][BLK][LDA];
  __shared__ __align__(16) int32_t Bs[2][BLK][TBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * TBM;
  const int n0 = blockIdx.x * TBN;

  // copy k-slice s into buffer buf
  auto stage = [&](int s, int buf) {
    stage_slice<BLK, TBM, TBN, LDA, TILED_THREADS>(As[buf], Bs[buf], A, B, M,
                                                   N, K, m0, n0, s);
  };

  int32_t part[OUTS][LOG_BLK];  // levels 0-3 of the running block
  int32_t slot[OUTS][TOP];      // levels 4 and up
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
#pragma unroll
    for (int l = 0; l < LOG_BLK; ++l) part[o][l] = 0;
#pragma unroll
    for (int l = 0; l < TOP; ++l) slot[o][l] = 0;
  }

  // product q of the slice in buffer buf, for every output of the
  // micro-tile, folded by fold(o, v)
  auto products = [&](int buf, int q, auto fold) {
    int32_t a[TM];
    int32_t b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[buf][q][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[buf][q][tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        fold(i * TN + j, product_modes<RND, OVF, ROUTE>(p, a[i], b[j]));
      }
    }
  };

  const int slices = (K + BLK - 1) / BLK;
  stage(0, 0);
  int t = 0;  // full blocks pushed so far
  for (int s = 0; s < slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < slices) {
      stage(s + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int cnt = min(BLK, K - s * BLK);  // products in this block
    if constexpr (RND != qk::ANY && OVF != qk::ANY) {
      // the slice unrolled: q is a constant in every copy
      for_each_q(std::make_integer_sequence<int, BLK>{}, [&](auto qc) {
        constexpr int Q = decltype(qc)::value;
        if (Q < cnt) {
          products(buf, Q, [&](int o, int32_t v) {
            fold_static<Q, TOP, RND, OVF>(part[o], slot[o], t, v, p.fold);
          });
        }
      });
    } else {
#pragma unroll 1
      for (int q = 0; q < cnt; ++q) {
        products(buf, q, [&](int o, int32_t v) {
          fold_dynamic<TOP>(q, part[o], slot[o], t, v, p.fold);
        });
      }
    }
    if (cnt == BLK) ++t;
    __syncthreads();  // buf is refilled by the next iteration's copies
  }

  // the drain: levels 0-3 from the partials, 4 and up from the stack
  int32_t carry[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) carry[o] = 0;
  const qk::Fold& f = p.fold;
  for (int s = 0; s < f.ndrain; ++s) {
    const int l = f.drain_lvl[s];
    const int op = f.drain_op[s];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      if (op == qk::CONVERT) {
        carry[o] = qk::requant(carry[o], f.merge[l]);
      } else {
        const int32_t sv = l < LOG_BLK ? qk::pick(part[o], l)
                                       : qk::pick(slot[o], l - LOG_BLK);
        carry[o] = op == qk::SEED ? sv : qk::merge(f, l, sv, carry[o]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (r < M && c < N) {
        qk::store_lane(C, (size_t)r * N + c,
                       qk::requant(carry[i * TN + j], p.fin), out_bytes);
      }
    }
  }
}

template <int TOP, int TM, int TN, int MINB, int RND, int OVF, int ROUTE>
void launch_tiled(const int32_t* a, const int32_t* b, void* c, int m, int n,
                  int k, int out_bytes, const TreeParams& p,
                  cudaStream_t stream) {
  const dim3 grid((n + 16 * TN - 1) / (16 * TN), (m + 16 * TM - 1) / (16 * TM));
  tree_gemm_tiled_kernel<TOP, TM, TN, MINB, RND, OVF, ROUTE>
      <<<grid, TILED_THREADS, 0, stream>>>(a, b, c, m, n, k, out_bytes, p);
}

}  // namespace

namespace qk {

// The (round, overflow) pairs and product routes that K2 has
// instantiations for, by index; 0 reads them at run time.  Each pair of
// ops/tree_gemm.py:K2_MODES has two entries: its int32 routes, then its
// 64-bit product route (ops/tree_gemm.py:k2_modes).
constexpr int K2_MODES[][3] = {{ANY, ANY, ANY},
                               {TRN_TCPL, SAT_ZERO, INT32_ROUTES},
                               {TRN_TCPL, SAT_ZERO, ROUTE_PAIR}};
constexpr int K2_NMODES = sizeof(K2_MODES) / sizeof(K2_MODES[0]);

// K2 for k / 16 full blocks below 2^TOP, modes K2_MODES[MODES].  The
// micro-tile and the blocks per SM: 2 x 1 outputs a thread and 4 blocks an
// SM (measured best at TOP = 8, for both mode instantiations); one output
// and 2 blocks for the deep stack, to keep it in registers.
template <int TOP, int MODES>
void launch_k2(const int32_t* a, const int32_t* b, void* c, int m, int n,
               int k, int out_bytes, const TreeParams& p,
               cudaStream_t stream) {
  constexpr int TM = TOP <= 8 ? 2 : 1;
  constexpr int MINB = TOP <= 8 ? 4 : 2;
  launch_tiled<TOP, TM, 1, MINB, K2_MODES[MODES][0], K2_MODES[MODES][1],
               K2_MODES[MODES][2]>(a, b, c, m, n, k, out_bytes, p, stream);
}

#define QK_K2_INSTANCE(TOP, MODES)                                         \
  template void launch_k2<TOP, MODES>(const int32_t*, const int32_t*,      \
                                      void*, int, int, int, int,           \
                                      const TreeParams&, cudaStream_t)
extern QK_K2_INSTANCE(8, 0);
extern QK_K2_INSTANCE(8, 1);
extern QK_K2_INSTANCE(8, 2);
extern QK_K2_INSTANCE(MAXL, 0);
extern QK_K2_INSTANCE(MAXL, 1);
extern QK_K2_INSTANCE(MAXL, 2);

}  // namespace qk
