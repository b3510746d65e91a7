// P1's C entry point: the probe that measures the tree GEMM's per-product
// work (chain_probe.cuh has the kernel and its notes, chain_probe_<PLAN>.cu
// its instantiations).  K2 (the tree GEMM on its blocked schedule) is
// tree_gemm_tiled.cu, K2' (on its one-pass schedule) tree_gemm_stream.cu.

#include "chain_probe.cuh"

static_assert(qk::K2S_NPLANS == 2, "qk_chain_probe launches plans 0 and 1");

// P1 over `programs` copies of an [elems] tile of int32 x and y into out
// [programs, elems]; params as qk_tree_gemm's, with any log_blk (the
// product route, the product's requantize and layer 0's merge are read);
// plan indexes K2S_PLANS (ops/chain_probe.py:p1_plan).  Returns a
// cudaError_t, or -1 for arguments outside the kernel's range.
extern "C" int qk_chain_probe(int device, const void* x, const void* y,
                              void* out, int elems, int programs, int steps,
                              const int* params, int plan, void* stream) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || elems < 1 || programs < 0 ||
      steps < 0 || !qk::p1_match(p, plan)) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (plan ? qk::launch_p1<1> : qk::launch_p1<0>)(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), elems, programs, steps, p,
      static_cast<cudaStream_t>(stream));
}
