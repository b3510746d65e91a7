// Variants of the package's P1 kernel (csrc/chain_probe.cuh, included
// here), timed by experiments/kernel_sweeps.py to choose its design: the
// chains a thread, the threads a block, whether y's split is hoisted out
// of the step loop, and whether the run-time plan's invariants are hoisted
// by hand (p1::RunTime, the package's) or left to the compiler
// (FirstDesign).  Not part of the package's kernels.
//
// kernel_sweeps.py compiles this file once for each P1_VARIANT, all at
// once, into one library; each defines p1_variant_<P1_VARIANT>, which
// computes P1's function (qk_chain_probe's arguments, without the plan
// index and the stream) or returns -1 for a plan it has not compiled in.
// The package's own instantiations are timed through its entry point.

#include "chain_probe.cuh"

namespace {

// The canonical plan's compiled step with y passed through an opaque move
// at every step, so that the compiler cannot hoist its split out of the
// step loop (ptxas drops the move and recomputes the split once for each
// group of 4 unrolled steps: PERF.md).
struct Recomputed {
  static constexpr bool ROLLED = false;
  using Y = int32_t;

  static __device__ __forceinline__ Y prepare(const TreeParams&,
                                              int32_t y) {
    return y;
  }

  static __device__ __forceinline__ int32_t step(const TreeParams& p,
                                                 int32_t v, Y y) {
    asm volatile("mov.b32 %0, %0;" : "+r"(y));
    return p1::Chain<1>::step(p, v, y);
  }
};

// The first design of the run-time plan: Chain's step on qk::Steps<0>,
// every requantize step read from the parameters as K2' reads them, the
// loop rolled and its invariants left to the compiler.
struct FirstDesign : p1::Chain<0> {
  static constexpr bool ROLLED = true;
};

template <class Step, int CHAINS, int THREADS>
int run(const TreeParams& p, const void* x, const void* y, void* out,
        int elems, int programs, int steps) {
  return p1::launch<Step, CHAINS, THREADS>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), elems, programs, steps, p, nullptr);
}

// the package's run-time plan at other chains a thread
template <int CHAINS, int THREADS>
int hoisted(const TreeParams& p, const void* x, const void* y, void* out,
            int elems, int programs, int steps) {
  return (p.split ? run<p1::RunTime<true>, CHAINS, THREADS>
                  : run<p1::RunTime<false>, CHAINS, THREADS>)(
      p, x, y, out, elems, programs, steps);
}

}  // namespace

#define P1_CAT2(a, b) a##b
#define P1_CAT(a, b) P1_CAT2(a, b)

// Variants 1-8 have the canonical plan compiled in; 9-12 read any plan.
extern "C" int P1_CAT(p1_variant_, P1_VARIANT)(const void* x, const void* y,
                                               void* out, int elems,
                                               int programs, int steps,
                                               const int* params) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || elems < 1 || programs < 0 ||
      steps < 0 || (P1_VARIANT <= 8 && !qk::p1_match(p, 1))) {
    return -1;
  }
#if P1_VARIANT == 1
  return run<p1::Chain<1>, 1, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 2
  return run<p1::Chain<1>, 2, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 3
  return run<p1::Chain<1>, 4, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 4
  return run<p1::Chain<1>, 8, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 5
  return run<p1::Chain<1>, 4, 128>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 6
  return run<p1::Chain<1>, 4, 512>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 7
  return run<p1::Chain<1>, 4, 1024>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 8
  return run<Recomputed, 4, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 9
  return run<FirstDesign, 1, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 10
  return run<FirstDesign, 4, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 11
  return hoisted<2, 256>(p, x, y, out, elems, programs, steps);
#elif P1_VARIANT == 12
  return hoisted<4, 256>(p, x, y, out, elems, programs, steps);
#else
#error "P1_VARIANT must be 1 to 12"
#endif
}
