// K2': the C entry point of the one-pass tree GEMM (tree_gemm_stream.cuh
// has the kernel and its notes; tree_gemm_stream_<TOP>_<PLAN>.cu its
// instantiations).

#include "tree_gemm_stream.cuh"

namespace {

// Whether the plan's product route and requantize step, and every merge's
// step (the drain's converts are merges' requantizes), are those of
// K2S_PLANS[plan]; entry 0 takes any plan.
bool plan_match(const TreeParams& p, int levels, int plan) {
  if (plan == 0) return true;
  if (plan < 0 || plan >= qk::K2S_NPLANS) return false;
  const int* e = qk::K2S_PLANS[plan];
  if (p.route != e[0] || !qk::same_rq(p.prod, e + 1)) return false;
  for (int l = 0; l < levels; ++l) {
    if (!qk::same_rq(p.fold.merge[l], e + 6)) return false;
  }
  return true;
}

}  // namespace

// K2' on int32 A [m, k] (row pitch lda elements) and B [k, n] (pitch ldb),
// both with 16-byte aligned bases and pitches, C [m, n] contiguous in
// out_bytes lanes; params as read_params reads them, with log_blk = 0;
// plan indexes K2S_PLANS (ops/tree_gemm.py:k2s_plan).  Returns a
// cudaError_t, -1 for arguments outside the kernel's range, -2 if TMA
// cannot describe the operands.
extern "C" int qk_tree_gemm_stream(int device, const void* a, long long lda,
                                   const void* b, long long ldb, void* c,
                                   int m, int n, int k, int out_bytes,
                                   const int* params, int plan,
                                   void* stream) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || log_blk != 0 || k < 1 ||
      m < 1 || n < 1 || !plan_match(p, params[7], plan) || lda < k ||
      ldb < n || lda % 4 != 0 || ldb % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4)) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
  auto s = static_cast<cudaStream_t>(stream);
  if (bit_length(k) <= qk::K2S_TOP) {
    return (plan ? qk::launch_k2s<qk::K2S_TOP, 1>
                 : qk::launch_k2s<qk::K2S_TOP, 0>)(A, lda, B, ldb, c, m, n, k,
                                                   out_bytes, p, s);
  }
  if (plan && bit_length(k) <= qk::K2S_TOP2) {
    return qk::launch_k2s<qk::K2S_TOP2, 1>(A, lda, B, ldb, c, m, n, k,
                                           out_bytes, p, s);
  }
  return (plan ? qk::launch_k2s<qk::MAXL, 1> : qk::launch_k2s<qk::MAXL, 0>)(
      A, lda, B, ldb, c, m, n, k, out_bytes, p, s);
}
