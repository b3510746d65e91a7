// K2's k-slice staging (tree_gemm_tiled.cuh): a slice of A, transposed,
// and of B copied by cp.async into one of two shared-memory buffers.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const int32_t* src,
                                          bool valid) {
  // src-size 0 writes a zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Copy k-slice s of A [M, K] into As[k][row] and of B [K, N] into
// Bs[k][col] for the TBM x TBN tile at (m0, n0), zero past the matrices'
// edges, and commit the copies as one group.
template <int SLICE, int TBM, int TBN, int LDA, int THREADS>
__device__ __forceinline__ void stage_slice(int32_t (&As)[SLICE][LDA],
                                            int32_t (&Bs)[SLICE][TBN],
                                            const int32_t* A,
                                            const int32_t* B, int M, int N,
                                            int K, int m0, int n0, int s) {
  const int tid = threadIdx.x;
  const int k0 = s * SLICE;
  for (int e = tid; e < TBM * SLICE; e += THREADS) {
    const int c = e % SLICE;
    const int r = e / SLICE;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async4(&As[c][r], ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
  }
  for (int e = tid; e < SLICE * TBN; e += THREADS) {
    const int c = e % TBN;
    const int r = e / TBN;
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async4(&Bs[r][c], ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace
