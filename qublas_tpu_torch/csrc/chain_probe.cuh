// P1, the probe of the tree GEMM's per-product work as a serial chain.
// This header holds the kernel template and its launcher qk::launch_p1;
// tree_gemm.cu has the C entry point qk_chain_probe, chain_probe_<PLAN>.cu
// one instantiation each, so that nvcc builds them in parallel.
//
// P1 replaces the Pallas kernel of bench.py:_measured_chain_prods (build,
// pallas_call at bench.py:418): on one [BM, BN] tile, T dependent steps
//
//     p = product(v, y);  v = merge(0, p, p)
//
// written by each of G programs.  There the grid ran the G programs one
// after another on one core; here every chain of every program runs at
// once, each in a register, and each program computes its own chains: no
// result is shared across programs and no chain leaves early, however soon
// it reaches 0 (0 is a fixed point of the canonical step, and most of
// measured_chain_prods' chains are 0 after one step).
//
// What bounds it on the H100: int32 issue.  A step of the canonical plan
// is about 10 dependent operations against 4 bytes stored a chain after T
// steps, and the chain cannot overlap its own steps.  The design, for that
// bound:
//  * the plans of qk::K2S_PLANS (plan_steps.cuh: the canonical
//    Qu<8,8,TRN::TCPL,SAT::ZERO>) have the product's and layer 0's merge's
//    whole requantize step compiled in (Steps<PLAN>), so a step folds to
//    the split multiply (IMAD, SHF, IMAD, with y's split into its high and
//    low bits hoisted out of the loop: y never changes along a chain), the
//    merge's add and a SAT::ZERO range check after each (add, unsigned
//    compare, select).  Every other plan (entry 0) reads its steps at run
//    time with the step loop rolled, its product route (i32, split, or
//    the 64-bit pair product) chosen once a launch and y's split once a
//    chain;
//  * CHAINS independent chains a thread: their steps interleave, so a
//    thread has CHAINS instructions to issue for each step's latency;
//  * x and y are read and out written CHAINS neighbours at a time (16-byte
//    vectors for CHAINS 4) when a tile's length is a multiple of CHAINS
//    and the bases are aligned; otherwise each chain reads and writes its
//    own element (the scalar path), so any tile and program count works.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "plan_steps.cuh"

namespace p1 {

// One step of a chain on plan PLAN (> 0) with qk::Steps<PLAN>'s product
// and merge, their requantize steps constants.  prepare() is what a chain
// computes once from its y: y itself, since the product's split of y is
// then loop-invariant and the compiler hoists it.
template <int PLAN>
struct Chain {
  static constexpr bool ROLLED = false;
  using Y = int32_t;

  static __device__ __forceinline__ Y prepare(const TreeParams&,
                                              int32_t y) {
    return y;
  }

  static __device__ __forceinline__ int32_t step(const TreeParams& p,
                                                 int32_t v, Y y) {
    const int32_t prod = qk::Steps<PLAN>::product(p, v, y);
    return qk::Steps<PLAN>::merge(p.fold, 0, prod, prod);
  }
};

// One step with every requantize step read at run time (plan 0), the loop
// rolled and its invariants hoisted by hand, which the compiler does not
// do for qk::Steps<0> (PERF.md): the product route (a qk::Route) is chosen
// once a launch (ROUTE), y's split into its high and low bits once a chain.
template <int ROUTE>
struct RunTime {
  static constexpr bool ROLLED = true;
  static constexpr bool SPLIT = ROUTE == qk::ROUTE_SPLIT;
  struct Y {
    int32_t y, bl, bh;
  };

  static __device__ __forceinline__ Y prepare(const TreeParams& p,
                                              int32_t y) {
    if constexpr (SPLIT) {
      const int d = p.prod.d;
      return Y{y, (int32_t)((uint32_t)y & ((1u << d) - 1u)), qk::sar(y, d)};
    } else {
      return Y{y, 0, 0};
    }
  }

  // qk::requant_split_mul(a, b.y, r) with b's split given
  static __device__ __forceinline__ int32_t split_mul(int32_t a, const Y& b,
                                                      const qk::Rq& r) {
    const int d = r.d;
    const int32_t albl = qk::wmul(a, b.bl);
    const int32_t xh = qk::wadd(qk::wmul(a, b.bh), qk::sar(albl, d));
    int32_t out;
    if (r.round == qk::TRN_TCPL) {
      out = xh;
    } else {
      const int32_t xl = (int32_t)((uint32_t)albl & ((1u << d) - 1u));
      if (r.round == qk::TRN_SMGN) {
        const bool neg = ((a ^ b.y) < 0) && a != 0;
        out = qk::wadd(xh, (neg && xl != 0) ? 1 : 0);
      } else {
        const int32_t t = (int32_t)(1u << (d - 1));
        const bool nz = a != 0 && b.y != 0;
        const bool c = qk::carry_mode(r.round, xl > t, xl >= t, xl == t,
                                      ((a ^ b.y) < 0) && nz,
                                      ((a ^ b.y) >= 0) && nz, (xh & 1) != 0);
        out = qk::wadd(xh, c ? 1 : 0);
      }
    }
    return qk::overflow_i32(out, r);
  }

  static __device__ __forceinline__ int32_t step(const TreeParams& p,
                                                 int32_t v, const Y& y) {
    int32_t prod;
    if constexpr (SPLIT) {
      prod = split_mul(v, y, p.prod);
    } else if constexpr (ROUTE == qk::ROUTE_PAIR) {
      prod = qk::requant64((int64_t)v * y.y, p.prod);
    } else {
      prod = qk::requant(qk::wmul(v, y.y), p.prod);
    }
    return qk::requant(qk::wadd(prod, prod), p.fold.merge[0]);
  }
};

// The alignment that N neighbouring int32 need for the vector path:
// 16-byte vectors for N a multiple of 4, else one vector of 4 N bytes.
template <int N>
constexpr int VEC_BYTES = N % 4 == 0 ? 16 : 4 * N;

template <int N>
__device__ __forceinline__ void load(const int32_t* __restrict__ src,
                                     int32_t (&v)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0,
                "CHAINS is 1, 2 or a multiple of 4");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(src + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(src));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(src);
  }
}

template <int N>
__device__ __forceinline__ void store(int32_t* __restrict__ dst,
                                      const int32_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<int4*>(dst + i) =
          make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// out [programs, elems] from X, Y [elems]: thread t of block b owns the
// chains of the CHAINS flat outputs from (b THREADS + t) CHAINS; output i
// is element i % elems of program i / elems.  vec: elems % CHAINS == 0 and
// the bases aligned to VEC_BYTES<CHAINS>, so the thread's outputs are
// neighbours in one program.
template <class Step, int CHAINS, int THREADS>
__global__ void __launch_bounds__(THREADS)
chain_probe_kernel(const int32_t* __restrict__ X,
                   const int32_t* __restrict__ Y, int32_t* __restrict__ out,
                   int elems, long long total, int steps, bool vec,
                   const TreeParams p) {
  const long long first =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * CHAINS;
  if (first >= total) return;
  int32_t v[CHAINS];
  int32_t yv[CHAINS];
  if (vec) {
    const int e = (int)(first % elems);
    load(X + e, v);
    load(Y + e, yv);
  } else {
    // a chain past the end repeats the thread's first and is not stored
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const long long i = first + c < total ? first + c : first;
      const int e = (int)(i % elems);
      v[c] = __ldg(X + e);
      yv[c] = __ldg(Y + e);
    }
  }
  typename Step::Y y[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) y[c] = Step::prepare(p, yv[c]);
  if constexpr (Step::ROLLED) {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) v[c] = Step::step(p, v[c], y[c]);
    }
  } else {
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) v[c] = Step::step(p, v[c], y[c]);
    }
  }
  if (vec) {
    store(out + first, v);
  } else {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (first + c < total) out[first + c] = v[c];
    }
  }
}

template <int BYTES>
inline bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % BYTES == 0;
}

// Launch the kernel over `programs` copies of the [elems] tile.  Returns
// a cudaError_t, or -1 for a grid beyond the card's.
template <class Step, int CHAINS, int THREADS>
int launch(const int32_t* x, const int32_t* y, int32_t* out, int elems,
           int programs, int steps, const TreeParams& p,
           cudaStream_t stream) {
  const long long total = (long long)elems * programs;
  if (total == 0) return 0;
  const long long per_block = (long long)THREADS * CHAINS;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return -1;
  constexpr int B = VEC_BYTES<CHAINS>;
  const bool vec = elems % CHAINS == 0 && aligned<B>(x) && aligned<B>(y) &&
                   aligned<B>(out);
  chain_probe_kernel<Step, CHAINS, THREADS>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(x, y, out, elems, total,
                                                 steps, vec, p);
  return (int)cudaGetLastError();
}

}  // namespace p1

namespace qk {

// Chains a thread and threads a block of P1's instantiation for each entry
// of K2S_PLANS (ops/chain_probe.py:P1_CHAINS and P1_THREADS list the same),
// chosen by experiments/kernel_sweeps.py p1 (PERF.md).
constexpr int P1_CHAINS[] = {1, 4};
constexpr int P1_THREADS[] = {256, 256};
static_assert(sizeof(P1_CHAINS) == sizeof(int) * K2S_NPLANS &&
                  sizeof(P1_THREADS) == sizeof(int) * K2S_NPLANS,
              "one P1 shape for each entry of K2S_PLANS");

// Whether the plan's product route and requantize step and layer 0's merge
// step (all that P1 reads) are those of K2S_PLANS[plan]; entry 0 takes any
// plan.
inline bool p1_match(const TreeParams& p, int plan) {
  if (plan == 0) return true;
  if (plan < 0 || plan >= K2S_NPLANS) return false;
  const int* e = K2S_PLANS[plan];
  return p.route == e[0] && same_rq(p.prod, e + 1) &&
         same_rq(p.fold.merge[0], e + 6);
}

// P1 on plan K2S_PLANS[PLAN]; for PLAN = 0 one kernel for each product
// route.
template <int PLAN>
int launch_p1(const int32_t* x, const int32_t* y, int32_t* out, int elems,
              int programs, int steps, const TreeParams& p,
              cudaStream_t stream) {
  constexpr int C = P1_CHAINS[PLAN];
  constexpr int T = P1_THREADS[PLAN];
  if constexpr (PLAN == 0) {
    const auto run =
        p.route == ROUTE_SPLIT  ? p1::launch<p1::RunTime<ROUTE_SPLIT>, C, T>
        : p.route == ROUTE_PAIR ? p1::launch<p1::RunTime<ROUTE_PAIR>, C, T>
                                : p1::launch<p1::RunTime<ROUTE_I32>, C, T>;
    return run(x, y, out, elems, programs, steps, p, stream);
  } else {
    return p1::launch<p1::Chain<PLAN>, C, T>(x, y, out, elems, programs,
                                             steps, p, stream);
  }
}

#define QK_P1_INSTANCE(PLAN)                                              \
  template int launch_p1<PLAN>(const int32_t*, const int32_t*, int32_t*, \
                               int, int, int, const TreeParams&,         \
                               cudaStream_t)
extern QK_P1_INSTANCE(0);
extern QK_P1_INSTANCE(1);

}  // namespace qk
