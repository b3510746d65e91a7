// The tree GEMM's requantize steps with a plan compiled in, shared by K2'
// (tree_gemm_stream.cuh) and P1 (chain_probe.cuh): one table of the plans
// that have instantiations, K2S_PLANS, and Steps<PLAN>, the product and
// merge of plan PLAN with its whole requantize steps (shift, round,
// overflow, width, signedness) as constants, or read from the parameters
// for PLAN = 0.
#pragma once

#include <cstdint>

#include "tree_gemm.cuh"

namespace qk {

// The plans with instantiations, by index: the product route (a Route),
// then the product's requantize step and the step that every
// tree merge shares, each as Rq's fields (d, round, ovf, w, sgn).  Entry 0
// reads everything at run time.  ops/tree_gemm.py:K2S_PLANS lists the same
// entries after entry 0; K2' takes an entry when every merge has its step
// (ops/tree_gemm.py:k2s_plan), P1 when layer 0's does
// (ops/chain_probe.py:p1_plan).
constexpr int K2S_PLANS[][11] = {
    {ANY, ANY, ANY, ANY, ANY, ANY, ANY, ANY, ANY, ANY, ANY},
    {ROUTE_SPLIT, 8, TRN_TCPL, SAT_ZERO, 17, 1, 0, TRN_TCPL, SAT_ZERO, 17, 1},
};
constexpr int K2S_NPLANS = sizeof(K2S_PLANS) / sizeof(K2S_PLANS[0]);

// Whether the step r is the table's step at e (five fields).
inline bool same_rq(const Rq& r, const int* e) {
  return r.d == e[0] && r.round == e[1] && r.ovf == e[2] && r.w == e[3] &&
         r.sgn == e[4];
}

template <int D, int RND, int OVF, int W, int SGN>
__device__ __forceinline__ Rq rq_of() {
  return Rq{D, RND, OVF, W, SGN};
}

// K2S_PLANS[PLAN]'s step at column C as an Rq of constants.
template <int PLAN, int C>
__device__ __forceinline__ Rq plan_rq() {
  return rq_of<K2S_PLANS[PLAN][C], K2S_PLANS[PLAN][C + 1],
               K2S_PLANS[PLAN][C + 2], K2S_PLANS[PLAN][C + 3],
               K2S_PLANS[PLAN][C + 4]>();
}

// The product and merge steps of plan PLAN: compiled in (PLAN > 0; K2'
// unrolls its slice) or read from the parameters (PLAN = 0, rolled).
template <int PLAN>
struct Steps {
  static constexpr bool UNROLLED = PLAN != 0;
  static constexpr bool SPLIT =
      PLAN != 0 && K2S_PLANS[PLAN][0] == ROUTE_SPLIT;
  static_assert(PLAN == 0 || K2S_PLANS[PLAN][0] != ROUTE_PAIR,
                "compiled plans have an int32 product route");

  static __device__ __forceinline__ int32_t product(const TreeParams& p,
                                                    int32_t a, int32_t b) {
    if constexpr (PLAN == 0) {
      return qk::product(p, a, b);
    } else if constexpr (SPLIT) {
      return requant_split_mul(a, b, plan_rq<PLAN, 1>());
    } else {
      return requant(wmul(a, b), plan_rq<PLAN, 1>());
    }
  }

  // the drain's converting assignment at level l
  static __device__ __forceinline__ int32_t convert(const Fold& f, int l,
                                                    int32_t x) {
    if constexpr (PLAN == 0) return requant(x, f.merge[l]);
    else return requant(x, plan_rq<PLAN, 6>());
  }

  static __device__ __forceinline__ int32_t merge(const Fold& f, int l,
                                                  int32_t left,
                                                  int32_t right) {
    return convert(f, l, wadd(left, right));
  }
};

}  // namespace qk
