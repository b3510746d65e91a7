// K2h's tensor-core kernel (tree_gemm_hybrid_mma.cu has its design note and
// its entry point): the kernel template, with the tail's merges as a policy
// (Modes: their round and overflow modes fixed at compile time or read at
// run time) and the operands' lane bytes D as a parameter (1: int8 lanes,
// one s8 MMA a k16 step; 2 and 4: int16 and int32 lanes as byte digits),
// so that its instantiations and the experiments' variants
// (experiments/k2h_variants.cu) share it.
#pragma once

#include <type_traits>

#include "hybrid_tail.cuh"

namespace k2h {

constexpr int THREADS = 128;  // 4 warps, 2 x 2, each a 16 x 16 output tile
constexpr int TBM = 32;       // tile rows
constexpr int TBN = 32;       // tile columns
constexpr int KS = 64;        // products a stage
constexpr int STAGES = 3;
constexpr int OUTS = 8;       // outputs a thread
constexpr int MMA_K = 16;     // k of an m16n8k16 step
// a pair of the least blocks (2 x 2^HYB_MIN_LEVEL products) fills whole
// k16 steps, and an odd last one is half of one, zero-filled past K
static_assert((2 << HYB_MIN_LEVEL) % MMA_K == 0, "pairs of whole steps");
static_assert(KS % MMA_K == 0, "stages of whole steps");

// The stages of D-byte lanes: A [TBM][KS] and B [KS][TBN] elements, their
// rows padded so that the fragments' shared loads meet no bank conflict
// (A: 16 D bytes of padding a row keeps the rows g of a warp's (half
// warp's, quarter warp's) 4-, 8- or 16-byte loads on distinct banks; B: 8
// bytes, so that the rows 4t + i of its 2D-byte loads land 8 banks
// apart).  CLASSES: the digit products' shift classes that survive mod
// 2^32 (i + j of digits i and j, 8 (i + j) < 32).  MINB: blocks an SM the
// registers are sized for (D = 4's stages take twice D = 2's shared
// memory).
template <int D>
struct Lanes {
  static_assert(D == 1 || D == 2 || D == 4, "int8, int16 or int32 lanes");
  static constexpr int LDA = D * (KS + 16);  // A stage rows (bytes)
  static constexpr int LDB = D * TBN + 8;    // B stage rows (bytes)
  static constexpr int A_BYTES = TBM * LDA;
  static constexpr int B_BYTES = KS * LDB;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int CLASSES = 2 * D - 1 < 4 ? 2 * D - 1 : 4;
  static constexpr int MINB = D == 4 ? 2 : 4;
};
// the int8 kernel's (D = 1) stage layout, which FastStage and Frag read
constexpr int LDA = Lanes<1>::LDA;
constexpr int LDB = Lanes<1>::LDB;
constexpr int A_BYTES = Lanes<1>::A_BYTES;

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

// D += A B on one m16n8k16 tile of byte digits, each operand's bytes read
// as s8 (SA, SB) or u8 -> s32, wrapping (no .satfinite): the digit
// kernels' sums are taken mod 2^32.
#define K2H_MMA_DIGIT(TA, TB)                                              \
  asm("mma.sync.aligned.m16n8k16.row.col.s32." TA "." TB ".s32 "          \
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"             \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                     \
      : "r"(a0), "r"(a1), "r"(b))
template <bool SA, bool SB>
__device__ __forceinline__ void mma_digit(int32_t* d, uint32_t a0,
                                          uint32_t a1, uint32_t b) {
  if constexpr (SA && SB) {
    K2H_MMA_DIGIT("s8", "s8");
  } else if constexpr (SA) {
    K2H_MMA_DIGIT("s8", "u8");
  } else if constexpr (SB) {
    K2H_MMA_DIGIT("u8", "s8");
  } else {
    K2H_MMA_DIGIT("u8", "u8");
  }
}
#undef K2H_MMA_DIGIT

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

// The digit kernels' stages (D = 2, 4), on the main path's operands: A's
// rows aligned to 16 bytes (base and pitch), B's to 8.  A's 32 x 64D-byte
// slice is 128 D chunks of 16 bytes, D a thread, B's 64 x 32D-byte slice
// 256 D chunks of 8, 2D a thread; a thread's chunks lie 32 / D rows apart,
// their addresses set up once.
template <int D>
struct WideStage {
  static constexpr int CH = 4 * D;            // chunks a row (A and B)
  static constexpr int RSTEP = THREADS / CH;  // rows between a thread's
  const int8_t* a;  // this thread's first chunk of A at k 0, or A
  const int8_t* b;  // this thread's first chunk of B at k 0, or B
  long long lda;
  long long ldb;
  int ac;           // the A chunk's byte in the slice
  int arows;        // this thread's A chunks on rows below M
  int bvalid;       // bytes of the B chunks left of N
  int br;           // the first B chunk's row in the slice
  uint32_t adst;    // shared offsets in a stage
  uint32_t bdst;

  __device__ WideStage(const int8_t* A, long long lda_, const int8_t* B,
                       long long ldb_, int M, int N, int m0, int n0, bool) {
    const int tid = threadIdx.x;
    const int r = tid / CH;
    ac = (tid % CH) * 16;
    arows = max(0, min(D, (M - m0 - r + RSTEP - 1) / RSTEP));
    a = arows ? A + (size_t)(m0 + r) * lda_ + ac : A;
    br = r;
    const int bc = (tid % CH) * 8;
    bvalid = max(0, min(8, (N - n0) * D - bc));
    b = bvalid ? B + (size_t)br * ldb_ + (size_t)n0 * D + bc : B;
    lda = lda_;
    ldb = ldb_;
    adst = r * Lanes<D>::LDA + ac;
    bdst = Lanes<D>::A_BYTES + br * Lanes<D>::LDB + bc;
  }

  // copy the slice at k0 into the stage at s
  __device__ __forceinline__ void copy(uint8_t* s, int k0, int K) const {
    const int va = max(0, min(16, (K - k0) * D - ac));  // A's bytes here
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int v = i < arows ? va : 0;
      cp_async<16>(s + adst + i * RSTEP * Lanes<D>::LDA,
                   v ? a + (size_t)i * RSTEP * lda + (size_t)k0 * D : a, v);
    }
#pragma unroll
    for (int i = 0; i < 2 * D; ++i) {
      const int vb = k0 + br + RSTEP * i < K ? bvalid : 0;
      cp_async<8>(s + bdst + i * RSTEP * Lanes<D>::LDB,
                  vb ? b + (size_t)(k0 + RSTEP * i) * ldb : b, vb);
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

// The 4 x 4 byte transpose: r[j] holds byte j of w0, w1, w2 and w3, in
// that order, in eight byte permutes.
__device__ __forceinline__ void transpose_bytes(uint32_t w0, uint32_t w1,
                                                uint32_t w2, uint32_t w3,
                                                uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// One thread's fragments of one k16 step on D-byte lanes (D = 2, 4), as
// digit planes: digit d < D - 1 of every element is its byte d (u8), digit
// D - 1 its top byte (s8), so an element is the sum of its digits times
// 256^d.  a[h][d]: A's row g + 8h at k 4t..4t+3, read as one 2D-byte word
// pair (or 16-byte quad) and split by byte permutes; b[j][d]: tile j's
// column (the warp's column 2g + j) at k 4t..4t+3, from the 2D-byte words
// of columns 2g, 2g + 1 at each k, transposed.
template <int D>
struct DigitFrag {
  uint32_t a[2][D];
  uint32_t b[2][D];
  __device__ __forceinline__ void load(const uint8_t* as, const uint8_t* bs,
                                       int q) {
    constexpr int lda = Lanes<D>::LDA;
    constexpr int ldb = Lanes<D>::LDB;
    if constexpr (D == 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2 x =
            *reinterpret_cast<const uint2*>(as + 8 * h * lda + 32 * q);
        a[h][0] = __byte_perm(x.x, x.y, 0x6420);  // the low bytes
        a[h][1] = __byte_perm(x.x, x.y, 0x7531);  // the high bytes
      }
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(bs + (16 * q + i) * ldb);
      }
      uint32_t r[4];  // bytes 0-3 of the words: column 2g lo, hi, 2g + 1
      transpose_bytes(w[0], w[1], w[2], w[3], r);
      b[0][0] = r[0];
      b[0][1] = r[1];
      b[1][0] = r[2];
      b[1][1] = r[3];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(as + 8 * h * lda + 64 * q);
        transpose_bytes(x.x, x.y, x.z, x.w, a[h]);
      }
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint2*>(bs + (16 * q + i) * ldb);
      }
      transpose_bytes(w[0].x, w[1].x, w[2].x, w[3].x, b[0]);
      transpose_bytes(w[0].y, w[1].y, w[2].y, w[3].y, b[1]);
    }
  }
};

// The digit products of one k16 step on both n8 tiles: digit i of A times
// digit j of B into the accumulator of its shift class i + j (8 (i + j)
// bits), the classes that survive mod 2^32 only; v[c][4 j + r] is class
// c's register r of tile j.
template <int D>
__device__ __forceinline__ void mma_digits(
    int32_t (&v)[Lanes<D>::CLASSES][OUTS], const DigitFrag<D>& f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int h = 0; h < D; ++h) {
        if (i + h >= Lanes<D>::CLASSES) continue;
        int32_t* d = v[i + h] + 4 * j;
        if (i == D - 1 && h == D - 1) {
          mma_digit<true, true>(d, f.a[0][i], f.a[1][i], f.b[j][h]);
        } else if (i == D - 1) {
          mma_digit<true, false>(d, f.a[0][i], f.a[1][i], f.b[j][h]);
        } else if (h == D - 1) {
          mma_digit<false, true>(d, f.a[0][i], f.a[1][i], f.b[j][h]);
        } else {
          mma_digit<false, false>(d, f.a[0][i], f.a[1][i], f.b[j][h]);
        }
      }
    }
  }
}

// The dot of the digit products: the shift classes' sums, class c shifted
// by 8c, added in wrapping 32-bit arithmetic.
template <int D>
__device__ __forceinline__ void digit_sum(
    const int32_t (&v)[Lanes<D>::CLASSES][OUTS], int32_t (&out)[OUTS]) {
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    uint32_t x = 0;
#pragma unroll
    for (int c = 0; c < Lanes<D>::CLASSES; ++c) {
      x += static_cast<uint32_t>(v[c][o]) << (8 * c);
    }
    out[o] = static_cast<int32_t>(x);
  }
}

// A [M, K] (row pitch lda bytes), B [K, N] (row pitch ldb) of D-byte
// lanes, K a multiple of s = 2^p.level >= 8.  la, lb: log2 of the copy
// size of each operand's stages.  Tail: the pair's requantize and the push
// (Modes).  D = 1 (int8): one s8 MMA a k16 step and n8 tile; D = 2, 4: the
// digit products of mma_digits into the shift classes' accumulators, summed
// (digit_sum) where a pair of blocks ends.
template <class Tail, int D = 1>
__global__ void __launch_bounds__(THREADS, Lanes<D>::MINB)
tree_gemm_hybrid_mma_kernel(const int8_t* __restrict__ A, long long lda,
                            const int8_t* __restrict__ B, long long ldb,
                            void* __restrict__ C, int M, int N, int K,
                            int out_bytes, int la, int lb,
                            const HybridParams p) {
  using Lay = Lanes<D>;
  using Fragment = std::conditional_t<D == 1, Frag, DigitFrag<D>>;
  using Stage = std::conditional_t<D == 1, FastStage, WideStage<D>>;
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

  // the main path's copies (FastStage, WideStage), or stage_rows for
  // operands whose rows are aligned otherwise
  const bool fast = la >= (D == 1 ? 3 : 4) && lb == 3;
  const Stage fs(A, lda, B, ldb, M, N, m0, n0, la == 4);
  auto stage = [&](int st, int buf) {
    uint8_t* s = smem + buf * Lay::STAGE_BYTES;
    if (fast) {
      fs.copy(s, st * KS, K);
    } else {
      stage_rows(s, Lay::LDA, A, lda, m0, M, st * KS * D, K * D, TBM,
                 KS * D, la);
      stage_rows(s + Lay::A_BYTES, Lay::LDB, B, ldb, st * KS, K, n0 * D,
                 N * D, KS, TBN * D, lb);
    }
  };

  const int stages = (K + KS - 1) / KS;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < stages) stage(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int32_t acc[Lay::CLASSES][OUTS];  // the running pair's dot (its classes)
  int32_t first[OUTS];  // stack level 0: the odd last block
  int32_t l1[OUTS];     // stack levels 1 and 2
  int32_t l2[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
#pragma unroll
    for (int c = 0; c < Lay::CLASSES; ++c) acc[c][o] = 0;
    first[o] = l1[o] = l2[o] = 0;
  }
  SharedSlots slots{first, l1, l2, reinterpret_cast<int32_t*>(
                                       smem + STAGES * Lay::STAGE_BYTES) +
                                       tid};
  int pairs = 0;  // pair values so far
  // Two blocks, 2s products: tree level L's merge adds their values, which
  // is the exact dot of the 2s products (the MMAs' accumulation: at most
  // 2^18 for 16 int8 products, and the plan keeps the sum of two level-L
  // values inside int32; the digit classes' sums wrap, and so does their
  // sum, to that dot mod 2^32), shifted; so a pair is one accumulation and
  // one requantize, and s = 8 is one m16n8k16 step, unmasked.
  const int pmask = (2 << p.level) - 1;

  // A pair's dot v: shifted to tree level L, the pair's requantize, and
  // its place on the stack: the binary carry of stack levels 1 and 2 with
  // the levels fixed, in registers, and one push onto level 3 in four
  // pairs.
  auto pair_done = [&](int32_t (&v)[OUTS]) {
    if (p.dl != 0) hybrid_shift(v, p.dl);
    Tail::pair(p.fold, v);
    if ((pairs & 1) == 0) {
#pragma unroll
      for (int o = 0; o < OUTS; ++o) l1[o] = v[o];
    } else {
      Tail::template merge<1>(p.fold, l1, v);
      if ((pairs & 2) == 0) {
#pragma unroll
        for (int o = 0; o < OUTS; ++o) l2[o] = v[o];
      } else {
        Tail::template merge<2>(p.fold, l2, v);
        Tail::push(slots, v, pairs >> 2, p.fold);
      }
    }
    ++pairs;
  };

  // k16 step q of the stage at k0: its MMAs, and where a pair of blocks
  // ends, pair_done.  Where K ends an odd block, its value goes to stack
  // level 0.  The stage's zero fill past K makes a last half step of 8
  // products that block's dot.
  auto step = [&](const Fragment& fr, int k0, int q) {
    if constexpr (D == 1) {
      mma_pair(acc[0], fr.a0, fr.a1, fr.b, acc[0]);
    } else {
      mma_digits<D>(acc, fr);
    }
    const int kend = min(k0 + 16 * q + 16, K);
    if ((kend & pmask) == 0) {
      if constexpr (D == 1) {
        pair_done(acc[0]);
      } else {
        int32_t v[OUTS];
        digit_sum<D>(acc, v);
        pair_done(v);
      }
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
#pragma unroll
        for (int c = 0; c < Lay::CLASSES; ++c) acc[c][o] = 0;
      }
    } else if (kend == K) {
      if constexpr (D == 1) {
        if (p.dl != 0) hybrid_shift(acc[0], p.dl);
#pragma unroll
        for (int o = 0; o < OUTS; ++o) first[o] = acc[0][o];
      } else {
        digit_sum<D>(acc, first);
        if (p.dl != 0) hybrid_shift(first, p.dl);
      }
    }
  };

  // this thread's fragments' offsets in a stage
  const int aoff = (wm * 16 + g) * Lay::LDA + 4 * t * D;
  const int boff = Lay::A_BYTES + 4 * t * Lay::LDB + (wn * 16 + 2 * g) * D;
  int rbuf = 0;           // the stage read now
  int wbuf = STAGES - 1;  // the stage copied now
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // stage st is in; stage st - 1's buffer is free
    if (st + STAGES - 1 < stages) stage(st + STAGES - 1, wbuf);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint8_t* as = smem + rbuf * Lay::STAGE_BYTES + aoff;
    const uint8_t* bs = smem + rbuf * Lay::STAGE_BYTES + boff;
    rbuf = rbuf == STAGES - 1 ? 0 : rbuf + 1;
    wbuf = wbuf == STAGES - 1 ? 0 : wbuf + 1;
    const int k0 = st * KS;
    const int steps = (min(KS, K - k0) + 15) >> 4;
    if constexpr (Tail::UNROLL) {
      Fragment fr[KS / MMA_K];
#pragma unroll
      for (int q = 0; q < KS / MMA_K; ++q) fr[q].load(as, bs, q);
#pragma unroll
      for (int q = 0; q < KS / MMA_K; ++q) {
        if (q < steps) step(fr[q], k0, q);
      }
    } else {
#pragma unroll 1
      for (int q = 0; q < steps; ++q) {
        Fragment fr;
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
template <int D = 1>
inline int smem_bytes(int levels) {
  return STAGES * Lanes<D>::STAGE_BYTES +
         max(levels - 3, 0) * OUTS * THREADS * 4;
}
template <int D = 1>
constexpr int smem_most() {
  return STAGES * Lanes<D>::STAGE_BYTES + 25 * OUTS * THREADS * 4;
}
static_assert(smem_most<4>() <= 232448, "a block's shared memory");

// Launch the kernel's instantiation for Tail on D-byte A [m, k] (row pitch
// lda bytes) and B [k, n] (row pitch ldb bytes), C [m, n] in out_bytes
// lanes: its shared memory limit raised once a device, the operands' copy
// sizes from their alignment.  Returns a cudaError_t.
template <class Tail, int D = 1>
int launch(int device, const void* a, long long lda, const void* b,
           long long ldb, void* c, int m, int n, int k, int out_bytes,
           int levels, const HybridParams& p, cudaStream_t stream) {
  auto kernel = tree_gemm_hybrid_mma_kernel<Tail, D>;
  static unsigned long long raised;  // devices whose limit is raised
  if (device >= 64 || !((raised >> device) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_most<D>());
    if (err != cudaSuccess) return (int)err;
    if (device < 64) raised |= 1ull << device;
  }
  const dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM);
  kernel<<<grid, THREADS, smem_bytes<D>(levels), stream>>>(
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

// launch() with the modes of K2H_MODES[MODES] on D-byte lanes: one
// instantiation a source file (tree_gemm_hybrid_mma.cu,
// tree_gemm_hybrid_mma_<MODES>.cu for int8 lanes,
// tree_gemm_hybrid_mma_d<D>_<MODES>.cu for the digit kernels), so they
// compile in parallel.
template <int MODES, int D = 1>
int launch_modes(int device, const void* a, long long lda, const void* b,
                 long long ldb, void* c, int m, int n, int k, int out_bytes,
                 int levels, const HybridParams& p, cudaStream_t stream) {
  return launch<Modes<K2H_MODES[MODES][0], K2H_MODES[MODES][1],
                      K2H_MODES[MODES][2]>,
                D>(device, a, lda, b, ldb, c, m, n, k, out_bytes, levels, p,
                   stream);
}

#define K2H_INSTANCE(MODES)                                                  \
  template int launch_modes<MODES>(int, const void*, long long, const void*, \
                                   long long, void*, int, int, int, int, int, \
                                   const HybridParams&, cudaStream_t)
#define K2H_DIGIT_INSTANCE(D, MODES)                                         \
  template int launch_modes<MODES, D>(                                       \
      int, const void*, long long, const void*, long long, void*, int, int, \
      int, int, int, const HybridParams&, cudaStream_t)
extern K2H_INSTANCE(0);
extern K2H_INSTANCE(1);
extern K2H_INSTANCE(2);
extern K2H_DIGIT_INSTANCE(2, 0);
extern K2H_DIGIT_INSTANCE(2, 1);
extern K2H_DIGIT_INSTANCE(2, 2);
extern K2H_DIGIT_INSTANCE(4, 0);
extern K2H_DIGIT_INSTANCE(4, 1);
extern K2H_DIGIT_INSTANCE(4, 2);

}  // namespace k2h
