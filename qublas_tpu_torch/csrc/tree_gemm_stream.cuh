// K2': the order-sensitive quantized tree GEMM on the one-pass schedule of
// qublas_tpu/ops/tree_gemm.py:tree_gemm_pallas (each product pushed
// through a slot stack of every tree level, slots_ref[l] in VMEM scratch).
// This header holds the kernel template and its launcher qk::launch_k2s;
// tree_gemm_stream.cu has the C entry point, tree_gemm_stream_<TOP>_<PLAN>.cu
// one instantiation each (qk::K2S_INSTANCES), so that nvcc builds them in
// parallel.
//
// The schedule: product number i of an output is a binary counter.  It
// merges once per trailing one-bit of i, the slot of that level the left
// operand (the layer's Qadd, tree_fold.cuh), and is stored at the level of
// i's first zero bit; after the last product the planner's drain ops
// (seed / convert / add, reading slot[l] at level l) finish the ragged
// right edge.  This is _slot_stack_plain(..., blk=1) of ops/tree_gemm.py
// and the reference's balanced tree (QuBLAS.h:4960-4990) for any k.
//
// What bounds it on the H100: int32 ALU work, about 14 counted operations
// a product (the requantized product, an amortised merge), against 12
// bytes of operands a product that shared memory serves many times over.
// The design, for that bound:
//  * a block of 256 threads owns a (16 TM) x (16 TN) output tile, each
//    thread a TM x TN register micro-tile, so each operand read from
//    shared memory serves TN or TM products;
//  * k arrives in slices of S = 2^LOG_S products, A as [rows][S] and B as
//    [S][cols] tiles, through a ring of STAGES shared-memory stages: TMA
//    copies issued by one thread and completed on an mbarrier per stage
//    (the Load policy; experiments/ has a 16-byte cp.async one).  TMA
//    zero-fills the box past the matrices' edges and needs a row pitch
//    and base that are multiples of 16 bytes: the wrapper hands over a
//    pitched copy otherwise, with k itself unpadded;
//  * one register stack slot[TOP] an output over every tree level.  The
//    slice is unrolled, so product q < S - 1 of a slice merges with and is
//    stored into compile-time slots; only the slice's last product reads
//    the slice counter's trailing ones at run time.  A ragged last slice
//    stops early and the drain reads slot[l] directly, so one kernel takes
//    any k;
//  * the plans of qk::K2S_PLANS (plan_steps.cuh: the canonical
//    Qu<8,8,TRN::TCPL,SAT::ZERO>) have the whole requantize step of the
//    product and of every merge compiled in (Steps<PLAN>): shift, round,
//    overflow, width and signedness, so each requantize folds to a few
//    instructions.  Every other plan (entry 0)
//    reads its steps at run time with the slice's loop rolled: unrolled,
//    the run-time requantize's code overflows the instruction cache.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "plan_steps.cuh"

namespace qk {

// The stack depths of the instantiations: K2S_TOP for k below 4096, then
// for the compiled plans K2S_TOP2 for k below 16384; MAXL above.
constexpr int K2S_TOP = 12;
constexpr int K2S_TOP2 = 14;

// The instantiations of launch_k2s, as tree_gemm_stream.cu chooses them:
// {stack depth, plan (0: steps read at run time, 1: K2S_PLANS[1] compiled
// in), outputs a thread (TM x 1), blocks an SM}.  Below k = 4096 the
// compiled plans take 4 x 1 outputs a thread and 3 blocks an SM, the
// fastest of 2 x 1, 4 x 1 and 2 x 2 at 2 to 4 blocks an SM; the run-time
// plan 2 x 1 and 4 blocks, as its rolled requantizes spill at 4 x 1.  From
// k = 4096 the compiled plan's two more levels take the tile below
// (PERF.md); the deepest stack one output and 2 blocks, to keep it in
// registers.
constexpr int K2S_INSTANCES[][4] = {
    {K2S_TOP, 0, 2, 4},
    {K2S_TOP, 1, 4, 3},
    {K2S_TOP2, 1, 4, 2},
    {MAXL, 0, 1, 2},
    {MAXL, 1, 1, 2},
};

// The row of K2S_INSTANCES for (top, plan), -1 if none.
constexpr int k2s_instance(int top, int plan) {
  for (int i = 0; i < int(sizeof(K2S_INSTANCES) / sizeof(K2S_INSTANCES[0]));
       ++i) {
    if (K2S_INSTANCES[i][0] == top && K2S_INSTANCES[i][1] == plan) return i;
  }
  return -1;
}

}  // namespace qk

namespace k2s {

constexpr int THREADS = 256;  // 16 x 16, each a TM x TN micro-tile
constexpr int STAGES = 3;     // shared-memory ring of k-slices

__host__ __device__ constexpr int trailing_ones(int q) {
  return (q & 1) ? 1 + trailing_ones(q >> 1) : 0;
}

// f(std::integral_constant<int, I>) for each I, in order.
template <int... I, class F>
__device__ __forceinline__ void unroll(std::integer_sequence<int, I...>,
                                       F&& f) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int J>
__device__ __forceinline__ int32_t lane(const int4& v) {
  if constexpr (J == 0) return v.x;
  else if constexpr (J == 1) return v.y;
  else if constexpr (J == 2) return v.z;
  else return v.w;
}

// ---- the requantize steps (plan_steps.cuh) ----

using qk::Steps;

// Fold product v, the Q-th of a full or ragged slice, into one output's
// stack: Q, its carries and its slot fixed at compile time; the slice's
// last product carries on through the levels above LOG_S by the trailing
// ones of the slice index s.
template <int Q, int LOG_S, int TOP, class St>
__device__ __forceinline__ void fold_static(int32_t (&slot)[TOP], int s,
                                            int32_t v, const qk::Fold& f) {
  constexpr int ONES = trailing_ones(Q);
#pragma unroll
  for (int l = 0; l < ONES; ++l) v = St::merge(f, l, slot[l], v);
  if constexpr (ONES == LOG_S) {
    const int up = __ffs(~s) - 1;
#pragma unroll
    for (int l = LOG_S; l < TOP; ++l) {
      if (l - LOG_S < up) v = St::merge(f, l, slot[l], v);
    }
#pragma unroll
    for (int l = LOG_S; l < TOP; ++l) {
      if (l - LOG_S == up) slot[l] = v;
    }
  } else {
    slot[ONES] = v;
  }
}

// slot[idx] for idx < N, by compare-and-select
template <int N, int TOP>
__device__ __forceinline__ int32_t pick_below(const int32_t (&slot)[TOP],
                                              int idx) {
  int32_t r = slot[0];
#pragma unroll
  for (int q = 1; q < N; ++q) {
    if (q == idx) r = slot[q];
  }
  return r;
}

// The same with the product's trailing ones read at run time: rolled
// carries, slots picked and stored by compare-and-select among the N
// lowest levels, the only ones that the product can reach.
template <int N, int TOP, class St>
__device__ __forceinline__ void fold_rolled(int32_t (&slot)[TOP], int ones,
                                            int32_t v, const qk::Fold& f) {
#pragma unroll 1
  for (int l = 0; l < ones; ++l) {
    v = St::merge(f, l, pick_below<N>(slot, l), v);
  }
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (l == ones) slot[l] = v;
  }
}

// ---- the loads: TMA into the ring, one mbarrier a stage ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of an int32 matrix [rows, cols], row pitch ld elements, in
// boxes of box_rows x box_cols, no swizzle; boxes past the edge read 0.
inline bool tensor_map(CUtensorMap* map, const int32_t* base, int rows,
                       int cols, long long ld, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
                const_cast<int32_t*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TmaLoad {
  struct Args {
    CUtensorMap a;  // A [M, K] in boxes of TBM x S
    CUtensorMap b;  // B [K, N] in boxes of S x TBN
  };

  static bool make(Args* g, const int32_t* a, long long lda, const int32_t* b,
                   long long ldb, int m, int n, int k, int tbm, int tbn,
                   int s) {
    return tensor_map(&g->a, a, m, k, lda, tbm, s) &&
           tensor_map(&g->b, b, k, n, ldb, s, tbn);
  }

  static __device__ __forceinline__ void init(uint64_t* full) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < STAGES; ++st) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_u32(&full[st]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // k-slice at k0 into as [TBM][S] and bs [S][TBN], completing on bar
  template <int TBM, int TBN, int S>
  static __device__ __forceinline__ void issue(const Args& g, int32_t* as,
                                               int32_t* bs, uint64_t* bar,
                                               int k0, int m0, int n0, int,
                                               int, int, bool valid) {
    if (!valid || threadIdx.x != 0) return;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"((TBM * S + S * TBN) * 4)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(as)),
        "l"(reinterpret_cast<uint64_t>(&g.a)), "r"(k0), "r"(m0),
        "r"(smem_u32(bar))
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(bs)),
        "l"(reinterpret_cast<uint64_t>(&g.b)), "r"(n0), "r"(k0),
        "r"(smem_u32(bar))
        : "memory");
  }

  // wait for the copies of the fill with this parity
  static __device__ __forceinline__ void wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    }
  }
};

// ---- the kernel ----

// C [M, N] (out_bytes lanes) = the tree GEMM of A [M, K] and B [K, N]
// int32, read through the Load policy's args g; k < 2^TOP.
template <int TOP, class St, int TM, int TN, int MINB, int LOG_S, class Load>
__global__ void __launch_bounds__(THREADS, MINB)
tree_gemm_stream_kernel(const __grid_constant__ typename Load::Args g,
                        void* __restrict__ C, int M, int N, int K,
                        int out_bytes, const TreeParams p) {
  constexpr int S = 1 << LOG_S;
  constexpr int TBM = 16 * TM;
  constexpr int TBN = 16 * TN;
  constexpr int OUTS = TM * TN;
  __shared__ __align__(128) int32_t As[STAGES][TBM][S];
  __shared__ __align__(128) int32_t Bs[STAGES][S][TBN];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * TBM;
  const int n0 = blockIdx.x * TBN;
  const int slices = (K + S - 1) >> LOG_S;

  Load::init(full);
  __syncthreads();
  auto issue = [&](int s) {
    const int st = s % STAGES;
    Load::template issue<TBM, TBN, S>(g, &As[st][0][0], &Bs[st][0][0],
                                      &full[st], s << LOG_S, m0, n0, M, N, K,
                                      s < slices);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  int32_t slot[OUTS][TOP];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
#pragma unroll
    for (int l = 0; l < TOP; ++l) slot[o][l] = 0;
  }

  for (int s = 0; s < slices; ++s) {
    const int st = s % STAGES;
    issue(s + STAGES - 1);  // into the stage that slice s - 1 left
    Load::wait(&full[st], (s / STAGES) & 1);
    const int cnt = min(S, K - (s << LOG_S));  // products in this slice
    if constexpr (St::UNROLLED) {
      // four products at a time: A's TM rows by one 16-byte load each
      unroll(std::make_integer_sequence<int, S / 4>{}, [&](auto gc) {
        constexpr int G = decltype(gc)::value;
        int4 av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          av[i] = *reinterpret_cast<const int4*>(&As[st][ty * TM + i][4 * G]);
        }
        unroll(std::make_integer_sequence<int, 4>{}, [&](auto jc) {
          constexpr int J = decltype(jc)::value;
          constexpr int Q = 4 * G + J;
          if (Q < cnt) {
            int32_t b[TN];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[st][Q][tx * TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                fold_static<Q, LOG_S, TOP, St>(
                    slot[i * TN + j], s,
                    St::product(p, lane<J>(av[i]), b[j]), p.fold);
              }
            }
          }
        });
      });
    } else {
#pragma unroll 1
      for (int q = 0; q < cnt; ++q) {
        int32_t a[TM];
        int32_t b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[st][ty * TM + i][q];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[st][q][tx * TN + j];
        const int ones = __ffs(~((s << LOG_S) + q)) - 1;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int32_t v = St::product(p, a[i], b[j]);
            if (q == S - 1) {  // carries on above the slice's levels
              fold_rolled<TOP, TOP, St>(slot[i * TN + j], ones, v, p.fold);
            } else {
              fold_rolled<LOG_S, TOP, St>(slot[i * TN + j], ones, v, p.fold);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }

  // the drain, reading slot[l] at tree level l, then the final requantize
  int32_t carry[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) carry[o] = 0;
  const qk::Fold& f = p.fold;
#pragma unroll 1
  for (int d = 0; d < f.ndrain; ++d) {
    const int l = f.drain_lvl[d];
    const int op = f.drain_op[d];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      if (op == qk::CONVERT) {
        carry[o] = St::convert(f, l, carry[o]);
      } else {
        const int32_t sv = qk::pick(slot[o], l);
        carry[o] = op == qk::SEED ? sv : St::merge(f, l, sv, carry[o]);
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

// Launch the kernel on A [m, k] (row pitch lda) and B [k, n] (pitch ldb).
// Returns a cudaError_t, or -2 if the Load policy cannot describe them.
template <int TOP, class St, int TM, int TN, int MINB, int LOG_S, class Load>
int launch(const int32_t* a, long long lda, const int32_t* b, long long ldb,
           void* c, int m, int n, int k, int out_bytes, const TreeParams& p,
           cudaStream_t stream) {
  typename Load::Args g;
  if (!Load::make(&g, a, lda, b, ldb, m, n, k, 16 * TM, 16 * TN,
                  1 << LOG_S)) {
    return -2;
  }
  const dim3 grid((n + 16 * TN - 1) / (16 * TN), (m + 16 * TM - 1) / (16 * TM));
  tree_gemm_stream_kernel<TOP, St, TM, TN, MINB, LOG_S, Load>
      <<<grid, THREADS, 0, stream>>>(g, c, m, n, k, out_bytes, p);
  return (int)cudaGetLastError();
}

}  // namespace k2s

namespace qk {

constexpr int K2S_LOG_S = 5;  // products per k-slice: 32

// K2' for k below 2^TOP, plan K2S_PLANS[PLAN], on the tile that
// K2S_INSTANCES gives it.
template <int TOP, int PLAN>
int launch_k2s(const int32_t* a, long long lda, const int32_t* b,
               long long ldb, void* c, int m, int n, int k, int out_bytes,
               const TreeParams& p, cudaStream_t stream) {
  constexpr int I = k2s_instance(TOP, PLAN);
  static_assert(I >= 0, "no such row of K2S_INSTANCES");
  constexpr int TM = K2S_INSTANCES[I][2];
  constexpr int MINB = K2S_INSTANCES[I][3];
  return k2s::launch<TOP, k2s::Steps<PLAN>, TM, 1, MINB, K2S_LOG_S,
                     k2s::TmaLoad>(a, lda, b, ldb, c, m, n, k, out_bytes, p,
                                   stream);
}

#define QK_K2S_INSTANCE(TOP, PLAN)                                          \
  template int launch_k2s<TOP, PLAN>(const int32_t*, long long,             \
                                     const int32_t*, long long, void*, int, \
                                     int, int, int, const TreeParams&,      \
                                     cudaStream_t)
extern QK_K2S_INSTANCE(K2S_TOP, 0);
extern QK_K2S_INSTANCE(K2S_TOP, 1);
extern QK_K2S_INSTANCE(K2S_TOP2, 1);
extern QK_K2S_INSTANCE(MAXL, 0);
extern QK_K2S_INSTANCE(MAXL, 1);

}  // namespace qk
