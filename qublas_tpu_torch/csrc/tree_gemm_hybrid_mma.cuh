// K2h's tensor-core kernel (tree_gemm_hybrid_mma.cu has its design note and
// its entry point): the kernel template, with the tail's merges as a policy
// (Modes: their round and overflow modes fixed at compile time or read at
// run time), so that its instantiations and the experiments' variants
// (experiments/k2h_variants.cu) share it.
#pragma once

#include "hybrid_tail.cuh"

namespace k2h {

constexpr int THREADS = 128;  // 4 warps, 2 x 2, each a 16 x 16 output tile
constexpr int TBM = 32;       // tile rows
constexpr int TBN = 32;       // tile columns
constexpr int KS = 64;        // products a stage
constexpr int STAGES = 3;
constexpr int LDA = KS + 16;  // A stage rows (bytes): conflict-free A reads
constexpr int LDB = TBN + 8;  // B stage rows (bytes): conflict-free B reads
constexpr int A_BYTES = TBM * LDA;
constexpr int B_BYTES = KS * LDB;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUTS = 8;       // outputs a thread
constexpr int MINB = 4;       // blocks an SM, at least
constexpr int MMA_K = 16;     // k of an m16n8k16 step
// a pair of the least blocks (2 x 2^HYB_MIN_LEVEL products) fills whole
// k16 steps, and an odd last one is half of one, zero-filled past K
static_assert((2 << HYB_MIN_LEVEL) % MMA_K == 0, "pairs of whole steps");
static_assert(KS % MMA_K == 0, "stages of whole steps");

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  // src-size < N fills the rest with zeros; 0 reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(N), "r"(valid)
               : "memory");
}

// Copy rows x cols bytes at (r0, c0) of src (row pitch `pitch` bytes, valid
// below row_lim and left of col_lim, zero elsewhere) into dst (row pitch
// dpitch) in chunks of 2^lv bytes: cp.async for 4, 8 and 16, byte loads
// for 1.
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dpitch,
                                           const int8_t* src,
                                           long long pitch, int r0,
                                           int row_lim, int c0, int col_lim,
                                           int rows, int cols, int lv) {
  const int vec = 1 << lv;
  const int lper = __ffs(cols) - 1 - lv;  // log2 of the chunks a row
#pragma unroll 1
  for (int e = threadIdx.x; e < rows << lper; e += THREADS) {
    const int r = e >> lper;
    const int c = (e - (r << lper)) << lv;
    const int gc = c0 + c;
    int valid = r0 + r < row_lim ? col_lim - gc : 0;
    valid = valid < 0 ? 0 : (valid > vec ? vec : valid);
    const int8_t* p = valid ? src + (size_t)(r0 + r) * pitch + gc : src;
    uint8_t* d = dst + r * dpitch + c;
    if (lv == 4) {
      cp_async<16>(d, p, valid);
    } else if (lv == 3) {
      cp_async<8>(d, p, valid);
    } else if (lv == 2) {
      cp_async<4>(d, p, valid);
    } else {
      *d = valid ? static_cast<uint8_t>(__ldg(p)) : 0;
    }
  }
}

// D = A B + C on one m16n8k16 tile: s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int32_t* d, uint32_t a0, uint32_t a1,
                                       uint32_t b, const int32_t* c) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// The two n8 tiles' dots of one k16 fragment: v[4 j + i] is tile j's
// register i, on top of c.
__device__ __forceinline__ void mma_pair(int32_t (&v)[OUTS], uint32_t a0,
                                         uint32_t a1, const uint32_t (&b)[2],
                                         const int32_t (&c)[OUTS]) {
  mma_s8(v, a0, a1, b[0], c);
  mma_s8(v + 4, a0, a1, b[1], c + 4);
}

// Stack levels 0 (`first`: an odd last block), 1 and 2 in registers (the
// kernel merges there with the levels fixed), levels 3 and up in shared
// memory, [level - 3][output][thread].
struct SharedSlots {
  int32_t (&l0)[OUTS];
  int32_t (&l1)[OUTS];
  int32_t (&l2)[OUTS];
  int32_t* sm;  // this thread's word of level 3, output 0
  __device__ int32_t get(int o, int l) const {
    return l == 0   ? l0[o]
           : l == 1 ? l1[o]
           : l == 2 ? l2[o]
                    : sm[((l - 3) * OUTS + o) * THREADS];
  }
  __device__ void set(int o, int l, int32_t x) {
    sm[((l - 3) * OUTS + o) * THREADS] = x;  // the push starts at level 3
  }
};

// The main path's stages: A's rows aligned to 16 bytes (a16: base and
// pitch) or to 8, and B's to 8.  Each thread copies one 16-byte chunk of
// A's 32 x 64 slice (row tid / 4), or two 8-byte chunks, and two 8-byte
// chunks of B's 64 x 32 slice (rows tid / 4 and tid / 4 + 32), from
// addresses set up once.
struct FastStage {
  const int8_t* a;  // this thread's chunk of A at k 0, or A
  const int8_t* b;  // this thread's chunk of B at k 0, or B
  long long ldb;
  int ac;           // the chunk's k in the slice (A)
  int bvalid;       // bytes of the B chunk left of N
  int arow_ok;      // the A chunk's row below M
  uint32_t adst;    // shared offsets in a stage
  uint32_t bdst;
  int br;           // the first B chunk's row in the slice
  bool a16;

  __device__ FastStage(const int8_t* A, long long lda, const int8_t* B,
                       long long ldb_, int M, int N, int m0, int n0,
                       bool a16_) {
    const int tid = threadIdx.x;
    const int ar = tid >> 2;
    ac = (tid & 3) * 16;
    arow_ok = m0 + ar < M;
    a = arow_ok ? A + (size_t)(m0 + ar) * lda + ac : A;
    br = tid >> 2;
    const int bc = (tid & 3) * 8;
    bvalid = max(0, min(8, N - (n0 + bc)));
    b = bvalid ? B + (size_t)br * ldb_ + n0 + bc : B;
    ldb = ldb_;
    adst = ar * LDA + ac;
    bdst = A_BYTES + br * LDB + bc;
    a16 = a16_;
  }

  // copy the slice at k0 into the stage at s
  __device__ __forceinline__ void copy(uint8_t* s, int k0, int K) const {
    const int left = arow_ok ? K - (k0 + ac) : 0;  // A's bytes from here
    if (a16) {
      const int va = max(0, min(16, left));
      cp_async<16>(s + adst, va ? a + k0 : a, va);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int va = max(0, min(8, left - 8 * h));
        cp_async<8>(s + adst + 8 * h, va ? a + k0 + 8 * h : a, va);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = k0 + br + 32 * h;
      const int vb = r < K ? bvalid : 0;
      cp_async<8>(s + bdst + 32 * h * LDB,
                  vb ? b + (size_t)(k0 + 32 * h) * ldb : b, vb);
    }
  }
};

// The tail's steps, with the round mode RND and the overflow modes OVF0 of
// tree level L (the pair's requantize) and OVF of the merges above it
// fixed, each qk::ANY for the mode read at run time.
// UNROLL: the stage's four k16 steps unrolled, their fragments read first
// (the compiled modes; with the modes read at run time the requantize's
// code is large, and the steps stay rolled).
template <int RND, int OVF0, int OVF>
struct Modes {
  static constexpr bool UNROLL = RND != qk::ANY;
  // tree level L's merge of a pair of blocks, given the sums of their
  // values: the dots of their 2s products, shifted
  static __device__ __forceinline__ void pair(const qk::Fold& f,
                                              int32_t (&v)[OUTS]) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      v[o] = requant_modes<RND, OVF0>(v[o], f.merge[0]);
    }
  }
  // the merge of stack level l's slots (the left operands) into v
  template <int l>
  static __device__ __forceinline__ void merge(const qk::Fold& f,
                                               const int32_t (&slot)[OUTS],
                                               int32_t (&v)[OUTS]) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      v[o] = requant_modes<RND, OVF>(qk::wadd(slot[o], v[o]), f.merge[l]);
    }
  }
  // the push of v onto stack level 3, t values pushed there before
  template <class Slots>
  static __device__ __forceinline__ void push(Slots& s, int32_t (&v)[OUTS],
                                              int t, const qk::Fold& f) {
    hybrid_push<RND, OVF>(s, v, 3, t, f);
  }
};

// One thread's fragments of one k16 step: A's rows g and g + 8 at k 4t..4t+3
// (a0, a1), and the B fragments of the two n8 tiles, from B's columns
// 2g, 2g + 1 at k 4t..4t+3 read as 16-bit words and transposed (MMA
// column g of tile j is the warp's column 2g + j).
struct Frag {
  uint32_t a0, a1;
  uint32_t b[2];
  __device__ __forceinline__ void load(const uint8_t* as, const uint8_t* bs,
                                       int q) {
    a0 = *reinterpret_cast<const uint32_t*>(as + 16 * q);
    a1 = *reinterpret_cast<const uint32_t*>(as + 8 * LDA + 16 * q);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = *reinterpret_cast<const uint16_t*>(bs + (16 * q + i) * LDB);
    }
    const uint32_t w01 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t w23 = __byte_perm(w[2], w[3], 0x5140);
    b[0] = __byte_perm(w01, w23, 0x5410);
    b[1] = __byte_perm(w01, w23, 0x7632);
  }
};

// A [M, K] (row pitch lda bytes), B [K, N] (row pitch ldb) int8, K a
// multiple of s = 2^p.level >= 8.  la, lb: log2 of the copy size of each
// operand's stages.  Tail: the pair's requantize and the push (Modes).
template <class Tail>
__global__ void __launch_bounds__(THREADS, MINB)
tree_gemm_hybrid_mma_kernel(const int8_t* __restrict__ A, long long lda,
                            const int8_t* __restrict__ B, long long ldb,
                            void* __restrict__ C, int M, int N, int K,
                            int out_bytes, int la, int lb,
                            const HybridParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's groupID
  const int t = lane & 3;   // and thread in group
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.y * TBM;
  const int n0 = blockIdx.x * TBN;

  // the main path's copies (FastStage), or stage_rows for operands whose
  // rows are aligned otherwise
  const bool fast = la >= 3 && lb == 3;
  const FastStage fs(A, lda, B, ldb, M, N, m0, n0, la == 4);
  auto stage = [&](int st, int buf) {
    uint8_t* s = smem + buf * STAGE_BYTES;
    if (fast) {
      fs.copy(s, st * KS, K);
    } else {
      stage_rows(s, LDA, A, lda, m0, M, st * KS, K, TBM, KS, la);
      stage_rows(s + A_BYTES, LDB, B, ldb, st * KS, K, n0, N, KS, TBN, lb);
    }
  };

  const int stages = (K + KS - 1) / KS;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) stage(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int32_t acc[OUTS];    // the running pair's dot
  int32_t first[OUTS];  // stack level 0: the odd last block
  int32_t l1[OUTS];     // stack levels 1 and 2
  int32_t l2[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) acc[o] = first[o] = l1[o] = l2[o] = 0;
  SharedSlots slots{first, l1, l2, reinterpret_cast<int32_t*>(
                                       smem + STAGES * STAGE_BYTES) + tid};
  int pairs = 0;  // pair values so far
  // Two blocks, 2s products: tree level L's merge adds their values, which
  // is the exact dot of the 2s products (the MMAs' accumulation: at most
  // 2^18 for 16 int8 products, and the plan keeps the sum of two level-L
  // values inside int32), shifted; so a pair is one accumulation and one
  // requantize, and s = 8 is one m16n8k16 step, unmasked.
  const int pmask = (2 << p.level) - 1;

  // k16 step q of the stage at k0: its MMAs, and where a pair of blocks
  // ends, the pair's requantize and its place on the stack: the binary
  // carry of stack levels 1 and 2 with the levels fixed, in registers, and
  // one push onto level 3 in four pairs.  Where K ends an odd block, its
  // value goes to stack level 0.  The stage's zero fill past K makes a last
  // half step of 8 products that block's dot.
  auto step = [&](const Frag& fr, int k0, int q) {
    mma_pair(acc, fr.a0, fr.a1, fr.b, acc);
    const int kend = min(k0 + 16 * q + 16, K);
    if ((kend & pmask) == 0) {
      if (p.dl != 0) hybrid_shift(acc, p.dl);
      Tail::pair(p.fold, acc);
      if ((pairs & 1) == 0) {
#pragma unroll
        for (int o = 0; o < OUTS; ++o) l1[o] = acc[o];
      } else {
        Tail::template merge<1>(p.fold, l1, acc);
        if ((pairs & 2) == 0) {
#pragma unroll
          for (int o = 0; o < OUTS; ++o) l2[o] = acc[o];
        } else {
          Tail::template merge<2>(p.fold, l2, acc);
          Tail::push(slots, acc, pairs >> 2, p.fold);
        }
      }
      ++pairs;
#pragma unroll
      for (int o = 0; o < OUTS; ++o) acc[o] = 0;
    } else if (kend == K) {
      if (p.dl != 0) hybrid_shift(acc, p.dl);
#pragma unroll
      for (int o = 0; o < OUTS; ++o) first[o] = acc[o];
    }
  };

  // this thread's fragments' offsets in a stage
  const int aoff = (wm * 16 + g) * LDA + 4 * t;
  const int boff = A_BYTES + 4 * t * LDB + wn * 16 + 2 * g;
  int rbuf = 0;           // the stage read now
  int wbuf = STAGES - 1;  // the stage copied now
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // stage st is in; stage st - 1's buffer is free
    if (st + STAGES - 1 < stages) stage(st + STAGES - 1, wbuf);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint8_t* as = smem + rbuf * STAGE_BYTES + aoff;
    const uint8_t* bs = smem + rbuf * STAGE_BYTES + boff;
    rbuf = rbuf == STAGES - 1 ? 0 : rbuf + 1;
    wbuf = wbuf == STAGES - 1 ? 0 : wbuf + 1;
    const int k0 = st * KS;
    const int steps = (min(KS, K - k0) + 15) >> 4;
    if constexpr (Tail::UNROLL) {
      Frag fr[KS / MMA_K];
#pragma unroll
      for (int q = 0; q < KS / MMA_K; ++q) fr[q].load(as, bs, q);
#pragma unroll
      for (int q = 0; q < KS / MMA_K; ++q) {
        if (q < steps) step(fr[q], k0, q);
      }
    } else {
#pragma unroll 1
      for (int q = 0; q < steps; ++q) {
        Frag fr;
        fr.load(as, bs, q);
        step(fr, k0, q);
      }
    }
  }

  int32_t res[OUTS];
  hybrid_drain(slots, res, p);
  // tile j's register i: row g + 8 (i >> 1), column 4t + 2 (i & 1) + j
  const int r = m0 + wm * 16 + g;
  const int c = n0 + wn * 16 + 4 * t;
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int rr = r + 8 * ((o & 3) >> 1);
    const int cc = c + 2 * (o & 1) + (o >> 2);
    if (rr < M && cc < N) {
      qk::store_lane(C, (size_t)rr * N + cc, res[o], out_bytes);
    }
  }
}

// log2 of the widest copy (up to 2^most bytes) that the base and the row
// pitch of an operand keep aligned.
inline int copy_log2(const void* base, long long pitch, int most) {
  int lv = most;
  while (lv > 0 && ((reinterpret_cast<uintptr_t>(base) | pitch) &
                    ((1 << lv) - 1)) != 0) {
    --lv;
  }
  return lv < 2 ? 0 : lv;
}

// The bytes of shared memory for a stack of `levels` levels: the stages,
// then stack levels 3 .. levels - 1 (levels <= 28: k < 2^31).
inline int smem_bytes(int levels) {
  return STAGES * STAGE_BYTES + max(levels - 3, 0) * OUTS * THREADS * 4;
}
constexpr int SMEM_MOST = STAGES * STAGE_BYTES + 25 * OUTS * THREADS * 4;

// Launch the kernel's instantiation for Tail on int8 A [m, k] (row
// pitch lda) and B [k, n] (row pitch ldb), C [m, n] in out_bytes lanes:
// its shared memory limit raised once a device, the operands' copy sizes
// from their alignment.  Returns a cudaError_t.
template <class Tail>
int launch(int device, const void* a, long long lda, const void* b,
           long long ldb, void* c, int m, int n, int k, int out_bytes,
           int levels, const HybridParams& p, cudaStream_t stream) {
  auto kernel = tree_gemm_hybrid_mma_kernel<Tail>;
  static unsigned long long raised;  // devices whose limit is raised
  if (device >= 64 || !((raised >> device) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MOST);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) raised |= 1ull << device;
  }
  const dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM);
  kernel<<<grid, THREADS, smem_bytes(levels), stream>>>(
      static_cast<const int8_t*>(a), lda, static_cast<const int8_t*>(b), ldb,
      c, m, n, k, out_bytes, copy_log2(a, lda, 4), copy_log2(b, ldb, 3), p);
  return (int)cudaGetLastError();
}

// The (round, tree level L's overflow, the levels above's overflow) modes
// that have instantiations, by index; 0 reads them at run time.  The
// configurations of ops/tree_gemm.py:K2H_MODES, in its order
// (ops/tree_gemm.py:k2h_modes picks one, tree_gemm_hybrid_mma.cu's
// modes_match checks it).
constexpr int K2H_MODES[][3] = {{qk::ANY, qk::ANY, qk::ANY},
                                {qk::TRN_TCPL, qk::SAT_ZERO, qk::SAT_ZERO},
                                {qk::TRN_TCPL, qk::SAT_TCPL, qk::SAT_ZERO}};
constexpr int K2H_NMODES = sizeof(K2H_MODES) / sizeof(K2H_MODES[0]);

// launch() with the modes of K2H_MODES[MODES]: one instantiation a source
// file (tree_gemm_hybrid_mma.cu, tree_gemm_hybrid_mma_<MODES>.cu), so they
// compile in parallel.
template <int MODES>
int launch_modes(int device, const void* a, long long lda, const void* b,
                 long long ldb, void* c, int m, int n, int k, int out_bytes,
                 int levels, const HybridParams& p, cudaStream_t stream) {
  return launch<Modes<K2H_MODES[MODES][0], K2H_MODES[MODES][1],
                      K2H_MODES[MODES][2]>>(device, a, lda, b, ldb, c, m, n,
                                            k, out_bytes, levels, p, stream);
}

#define K2H_INSTANCE(MODES)                                                  \
  template int launch_modes<MODES>(int, const void*, long long, const void*, \
                                   long long, void*, int, int, int, int, int, \
                                   const HybridParams&, cudaStream_t)
extern K2H_INSTANCE(0);
extern K2H_INSTANCE(1);
extern K2H_INSTANCE(2);

}  // namespace k2h
