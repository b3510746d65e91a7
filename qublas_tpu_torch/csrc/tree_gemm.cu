// P1, the probe that measures the tree GEMM's per-product work.  K2 (the
// tree GEMM on its blocked schedule) is tree_gemm_tiled.cu, K2' (on its
// one-pass schedule) tree_gemm_stream.cu.
//
// P1 (chain_probe_kernel) replaces the Pallas kernel of
// bench.py:_measured_chain_prods (build, pallas_call at bench.py:418): T
// dependent steps of product() and a layer-0 merge on one [BM, BN] tile,
// written G times.  There the grid runs the G programs one after another
// on one core; here one thread owns one output element of one program, so
// all G x BM x BN chains run in parallel and each keeps its value in a
// register.  Bound by int32 ALU work (T x ~20 operations per element
// against 4 bytes stored); being a dependent chain, each thread's steps
// cannot overlap, so it also measures the latency that enough warps per SM
// hide.

#include "tree_gemm.cuh"

namespace {

// P1: out[g, e] = x[e] after `steps` times v = merge(0, p, p) with
// p = product(v, y[e]); X, Y [elems] int32, out [programs, elems].
__global__ void __launch_bounds__(256)
chain_probe_kernel(const int32_t* __restrict__ X,
                   const int32_t* __restrict__ Y, int32_t* __restrict__ out,
                   int elems, long long total, int steps, const TreeParams p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int e = (int)(idx % elems);
  int32_t v = __ldg(X + e);
  const int32_t y = __ldg(Y + e);
  for (int s = 0; s < steps; ++s) {
    const int32_t prod = product(p, v, y);
    v = qk::merge(p.fold, 0, prod, prod);
  }
  out[idx] = v;
}

}  // namespace

// P1 over `programs` copies of an [elems] tile; params as qk_tree_gemm's,
// with any log_blk
// (the product route, the product's requantize and layer 0's merge are
// read).  Returns a cudaError_t, or -1 for parameters outside the range.
extern "C" int qk_chain_probe(int device, const void* x, const void* y,
                              void* out, int elems, int programs, int steps,
                              const int* params, void* stream) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || elems < 1 || programs < 0 ||
      steps < 0) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)elems * programs;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return -1;
  chain_probe_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), elems, total, steps, p);
  return (int)cudaGetLastError();
}
