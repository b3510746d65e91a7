// K2' (the order-sensitive quantized tree GEMM on its one-pass schedule)
// and P1, the probe that measures the tree GEMM's per-product work.  K2,
// the same GEMM on its blocked schedule, is tree_gemm_tiled.cu.
//
// Both GEMM kernels evaluate the reference's balanced tree over k
// (QuBLAS.h:4960-4990) with qublas_tpu/ops/tree_gemm.py:tree_gemm_scan's
// binary-carry schedule, proven there for any k: requantized products
// (route "i32" or "split") are counted in binary, each carry a layer's
// Qadd; the planner's drain ops finish the ragged right edge; a final
// requantize gives the output format.  No partial goes to device memory.
//
// K2' (tree_gemm_kernel<0, TOP>) replaces qublas_tpu/ops/tree_gemm.py:
// tree_gemm_pallas (one pass over k, each product pushed through a
// binary-carry slot stack in VMEM scratch): one thread owns one output
// element, every product read through L1 and pushed through the stack.
// Bound by int32 ALU work, about 14 operations per product (split
// multiply, rounding carry, saturation, an amortised tree merge).
//
// P1 (chain_probe_kernel) is the measurement probe of the same per-product
// work, replacing the Pallas kernel of bench.py:_measured_chain_prods
// (build, pallas_call at bench.py:418): T dependent steps of product() and
// a layer-0 merge on one [BM, BN] tile, written G times.  There the grid
// runs the G programs one after another on one core; here one thread owns
// one output element of one program, so all G x BM x BN chains run in
// parallel and each keeps its value in a register.  Bound by int32 ALU
// work (T x ~20 operations per element against 4 bytes stored); being a
// dependent chain, each thread's steps cannot overlap, so it also measures
// the latency that enough warps per SM hide.

#include "tree_gemm.cuh"

namespace {

// ---- K2' ----

// A [M, K], B [K, N] int32; K is a multiple of 2^LOG_BLK and
// K / 2^LOG_BLK < 2^TOP.
template <int LOG_BLK, int TOP>
__global__ void __launch_bounds__(256)
tree_gemm_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                 void* __restrict__ C, int M, int N, int K, int out_bytes,
                 const TreeParams p) {
  constexpr int BLK = 1 << LOG_BLK;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= M || j >= N) return;
  const int32_t* arow = A + (size_t)i * K;
  const int32_t* bcol = B + j;
  const int nblocks = K >> LOG_BLK;

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;

  for (int t = 0; t < nblocks; ++t) {
    int32_t v[BLK];
#pragma unroll
    for (int q = 0; q < BLK; ++q) {
      const size_t kk = ((size_t)t << LOG_BLK) + q;
      v[q] = product(p, __ldg(arow + kk), __ldg(bcol + kk * N));
    }
    qk::push<LOG_BLK, TOP>(slot, t, qk::fold_block<LOG_BLK>(v, p.fold),
                           p.fold);
  }
  const int32_t value = qk::drain<LOG_BLK, TOP>(slot, p.fold);
  qk::store_lane(C, (size_t)i * N + j, qk::requant(value, p.fin), out_bytes);
}

template <int LOG_BLK, int TOP>
void launch(const int32_t* a, const int32_t* b, void* c, int m, int n, int k,
            int out_bytes, const TreeParams& p, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (m + 7) / 8);
  tree_gemm_kernel<LOG_BLK, TOP><<<grid, block, 0, stream>>>(a, b, c, m, n, k,
                                                             out_bytes, p);
}

template <int LOG_BLK>
void launch_top(int top, const int32_t* a, const int32_t* b, void* c, int m,
                int n, int k, int out_bytes, const TreeParams& p,
                cudaStream_t stream) {
  if (top <= 8) {
    launch<LOG_BLK, 8>(a, b, c, m, n, k, out_bytes, p, stream);
  } else if (top <= 16) {
    launch<LOG_BLK, 16>(a, b, c, m, n, k, out_bytes, p, stream);
  } else {
    launch<LOG_BLK, qk::MAXL>(a, b, c, m, n, k, out_bytes, p, stream);
  }
}

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

// K2' on the same operands; params with log_blk = 0.
// Returns a cudaError_t, or -1 for parameters outside the kernel's range.
extern "C" int qk_tree_gemm_stream(int device, const void* a, const void* b,
                                   void* c, int m, int n, int k,
                                   int out_bytes, const int* params,
                                   void* stream) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || log_blk != 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int top = bit_length(k) > 1 ? bit_length(k) : 1;
  launch_top<0>(top, static_cast<const int32_t*>(a),
                static_cast<const int32_t*>(b), c, m, n, k, out_bytes, p,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

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
