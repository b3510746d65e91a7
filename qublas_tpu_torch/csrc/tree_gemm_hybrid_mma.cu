// K2h on the tensor cores: the prefix-lossless hybrid tree GEMM, for
// qgemul's hybrid tier, on int8 lanes (one s8 MMA a product step) and on
// int16 and int32 lanes as byte digits (the digit kernels).
//
// Replaces qublas_tpu/ops/tree_gemm.py:tree_gemm_hybrid (:620), which the
// JAX package runs as an XLA einsum on the MXU (the exact int32 dot of every
// block of s = 2^L products, into a [k/s, m, n] int32 intermediate) and then
// the quantized tail as VPU requantize folds.  The value at tree level L of
// each s-product subtree is the plain integer dot of its k-block shifted
// left by dl (ops/tree_gemm.py:plan_hybrid proves it); only the tail from
// level L up rounds and saturates.
//
// Bound on this card: the tail.  The block dots are int8 x int8 -> int32
// dots of s products, mma.sync m16n8k16 s8 (1,979 T op/s: about 9 us at
// 2048^3); the tail is, an output, a shift of each of the k / s block
// values, k / s - 1 merges (an add and a requantize) and the final
// requantize, at the SMs' int32 instruction rate: some eight times the
// dots' time.  The operand and output bytes are below both.  So the design
// keeps the tail's work and its slot traffic small and the dots out of its
// way:
//   * A [M, K] and B [K, N] arrive in their lanes, as they are: 64-product
//     stages by cp.async into a ring of three shared-memory stages, one
//     barrier a stage.  Rows aligned to 16 or 8 bytes (A) and 8 (B), the
//     main path's, take one or two copies of A and two of B a thread (int8;
//     D 16-byte copies of A and 2D 8-byte copies of B on D-byte lanes),
//     their addresses set up once; other operands take 8- or 4-byte copies
//     or byte loads in a rolled loop.
//   * The MMA's B fragment wants four k of one column in a register, and B
//     is row-major [K, N]: each thread reads the two columns 2g, 2g + 1 at
//     its four k as 16-bit words and transposes them with four byte
//     permutes into the fragments of two n8 tiles (MMA column g of tile j
//     is the warp's column 2g + j), so no copy of B is made.
//   * int16 and int32 lanes: the tensor cores take no s16 or s32 operand,
//     but .u8 and .s8 in either position.  An element of D bytes is
//     sum_d digit_d 256^d, its low bytes u8 and its top byte s8, so a dot
//     is sum_{i,j} 256^(i+j) (digit-i plane of A . digit-j plane of B):
//     four MMAs a k16 step and n8 tile on int16 lanes (u8 u8, u8 s8 and s8
//     u8 into one accumulator, s8 s8), ten on int32 lanes (the terms with
//     8 (i + j) >= 32 vanish mod 2^32), into an accumulator a shift class;
//     at a pair's end acc_0 + (acc_1 << 8) + (acc_2 << 16) (+ (acc_3 <<
//     24)), wrapping: the exact block dot where the plan proves it fits
//     int32, and the int32-wrapped dot (the JAX einsum's, the plain
//     version's) for raws outside the operands' formats.  The fragments
//     are byte permutes of the staged words: A's four elements of a row,
//     one 8- or 16-byte load, split into their digit planes; B's two
//     columns at four k, 4- or 8-byte loads, transposed.  Balanced signed
//     digits (the limb tier's) cannot take 32767, whose high digit would
//     be 128.  Mixed lanes widen the narrower operand to the wider lane (a
//     copy in the call).
//   * A warp owns a 16 x 16 output tile, a thread 8 outputs (rows g and
//     g + 8, columns 4t .. 4t + 3 of the warp's tile).
//   * Blocks go in pairs: tree level L's merge of blocks 2i and 2i + 1 adds
//     their shifted values, and that sum is the exact dot of their 2s
//     products, shifted.  So the MMAs accumulate over 2s products, and a
//     pair is one requantize (no add, no first block held).  A block of 8
//     needs no mask: a pair of them is one k16 step, and an odd last one
//     is the zero-filled half of the last step, kept in registers as
//     stack level 0 for the drain.
//   * Stack levels 1 and 2 live in registers, and the pairs' binary carry
//     through them is written out with the levels fixed (their merges'
//     steps hoisted); one value in four pairs goes on to the push onto
//     level 3 and up, in shared memory, [level][output][thread] (no bank
//     conflicts, no local memory): levels - 3 of them, 4 KiB each, sized
//     at launch (25 at most for any int k).  The push's carries run in a
//     rolled loop (hybrid_tail.cuh).
//   * The tail's modes: a requantize whose modes are read at run time has
//     a large mode dispatch (inlined at each merge it was specialized for
//     every mode; it is out of line now), and it took three quarters of
//     the kernel's time at 2048^3 (PERF.md §6).  So the modes of the
//     hybrid configurations are compiled in (K2H_MODES in
//     tree_gemm_hybrid_mma.cuh, one source an instantiation and lane
//     width; ops/tree_gemm.py:k2h_modes picks one, modes_match checks it),
//     and there the stage's four k16 steps are unrolled, their fragments
//     read first; other plans read their modes at run time, the steps
//     rolled.  The drain and the final requantize read theirs at run time
//     (once an output).
// The kernel template is tree_gemm_hybrid_mma.cuh's.

#include "tree_gemm_hybrid_mma.cuh"

namespace k2h {
K2H_INSTANCE(0);
}  // namespace k2h

namespace {

// The tail's merges of stack levels 0 .. levels - 1 have the modes of
// instantiation `modes`.
bool modes_match(const HybridParams& p, int levels, int modes) {
  if (modes == 0) return true;
  if (modes < 0 || modes >= k2h::K2H_NMODES) return false;
  for (int l = 0; l < levels; ++l) {
    const qk::Rq& r = p.fold.merge[l];
    if (r.round != k2h::K2H_MODES[modes][0] ||
        r.ovf != k2h::K2H_MODES[modes][l == 0 ? 1 : 2]) {
      return false;
    }
  }
  return true;
}

}  // namespace

// K2h's tensor-core kernels on A [m, k] (row pitch lda elements) and
// B [k, n] (row pitch ldb) of `digits`-byte lanes (1: int8, 2: int16,
// 4: int32; both operands in the same lane), C [m, n] in out_bytes lanes
// (contiguous); params as read_hybrid reads them, modes an index of
// K2H_MODES.  Returns a cudaError_t, or -1 for arguments outside the
// kernels' range.
extern "C" int qk_tree_gemm_hybrid_mma(int device, const void* a,
                                       long long lda, const void* b,
                                       long long ldb, void* c, int m, int n,
                                       int k, int out_bytes,
                                       const int* params, int modes,
                                       int digits, void* stream) {
  HybridParams p{};
  int levels;
  if (!read_hybrid(params, m, n, k, out_bytes, &p, &levels) || lda < k ||
      ldb < n || (m + k2h::TBM - 1) / k2h::TBM > 65535 ||
      !modes_match(p, levels, modes) ||
      (digits != 1 && digits != 2 && digits != 4) ||
      (long long)(k > n ? k : n) * digits > 0x7fffffffll) {
    return -1;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  static_assert(k2h::K2H_NMODES == 3,
                "qk_tree_gemm_hybrid_mma launches 0-2");
  using Launch = int (*)(int, const void*, long long, const void*, long long,
                         void*, int, int, int, int, int, const HybridParams&,
                         cudaStream_t);
  // [lane: int8, int16, int32][modes]
  constexpr Launch kLaunch[3][3] = {
      {k2h::launch_modes<0>, k2h::launch_modes<1>, k2h::launch_modes<2>},
      {k2h::launch_modes<0, 2>, k2h::launch_modes<1, 2>,
       k2h::launch_modes<2, 2>},
      {k2h::launch_modes<0, 4>, k2h::launch_modes<1, 4>,
       k2h::launch_modes<2, 4>}};
  const int lane = digits == 1 ? 0 : digits == 2 ? 1 : 2;
  return kLaunch[lane][modes](device, a, lda * digits, b, ldb * digits, c, m,
                              n, k, out_bytes, levels, p, s);
}
