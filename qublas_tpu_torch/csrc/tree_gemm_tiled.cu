// K2: the order-sensitive quantized tree GEMM on its blocked schedule, for
// qgemul's general tier (e.g. the canonical Qu<8,8,TRN::TCPL,SAT::ZERO>
// config).  K2' and P1 are tree_gemm.cu.
//
// Replaces qublas_tpu/ops/tree_gemm.py:tree_gemm_blocked, a Pallas kernel
// that folds each k-block in VMEM, then a separate jnp phase 2 over the
// per-block values in HBM.  Here no partial goes to device memory: the
// reference's balanced tree over k (QuBLAS.h:4960-4990) is evaluated with
// tree_gemm_scan's binary-carry schedule, proven there for any k.
//
// A block of 256 threads computes a (16 TM) x (16 TN) output tile; each
// thread owns a TM x TN register micro-tile, so every operand read from
// shared memory serves TN or TM products.  k-slices of 16 (A transposed,
// [16][rows]; B [16][cols]) arrive by cp.async into two buffers, the next
// slice's copies in flight while the current one is requantized.  Within a
// slice (one block of 16 products) the fold is incremental: after product
// q, one merge per trailing one-bit of q (the partials of levels 0-3 stay
// in registers, at most 5 live per output, in tree_fold.cuh's fold_block
// order); a full block's value goes onto the slot stack of levels 4 and up
// (tree_fold.cuh's push).  A ragged last slice leaves its partials in
// levels 0-3, where the drain reads them, so one kernel takes any k.
//
// Instantiations fix the (round, overflow) modes that the product and
// every merge share, and the product's 64-bit or int32 routes
// (ops/tree_gemm.py:k2_modes picks one, modes_match checks it), and unroll
// the slice, so q is a compile-time index; or they read the modes and the
// route at run time and keep the slice's loop rolled, partials picked by
// compare-and-select: sixteen unrolled copies of the run-time requantize
// are too much code for the instruction cache.  The micro-tile
// and the blocks per SM were chosen by measurement (PERF.md §6): the
// work is int32 ALU operations with short dependent chains, so resident
// warps count for more than operand reuse.

#include "tree_gemm_tiled.cuh"

namespace {

// Whether the product and every merge of the plan round and overflow with
// the pair K2_MODES[modes] (the drain's converts are merges' requantizes),
// and the product's route is the entry's.
bool modes_match(const TreeParams& p, int levels, int modes) {
  if (modes == 0) return true;
  if (modes < 0 || modes >= qk::K2_NMODES) return false;
  const int rnd = qk::K2_MODES[modes][0];
  const int ovf = qk::K2_MODES[modes][1];
  const int route = qk::K2_MODES[modes][2];
  if (route == qk::INT32_ROUTES ? p.route == qk::ROUTE_PAIR
                                : p.route != route) {
    return false;
  }
  if (p.prod.round != rnd || p.prod.ovf != ovf) return false;
  for (int l = 0; l < levels; ++l) {
    if (p.fold.merge[l].round != rnd || p.fold.merge[l].ovf != ovf) {
      return false;
    }
  }
  return true;
}

}  // namespace

// K2 on int32 A [m, k] and B [k, n], C [m, n] in out_bytes lanes; params
// as read_params reads them, with log_blk = 4; modes indexes K2_MODES.
// Returns a cudaError_t, or -1 for parameters outside the kernel's range.
extern "C" int qk_tree_gemm(int device, const void* a, const void* b, void* c,
                            int m, int n, int k, int out_bytes,
                            const int* params, int modes, void* stream) {
  TreeParams p{};
  int log_blk;
  if (!read_params(params, &p, &log_blk) || log_blk != LOG_BLK || k < 1 ||
      !modes_match(p, params[7], modes)) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int top = bit_length(k >> LOG_BLK) > 1 ? bit_length(k >> LOG_BLK) : 1;
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
  auto s = static_cast<cudaStream_t>(stream);
  static_assert(qk::K2_NMODES == 3, "qk_tree_gemm launches modes 0-2");
  const auto run =
      top <= 8 ? (modes == 2   ? qk::launch_k2<8, 2>
                  : modes == 1 ? qk::launch_k2<8, 1>
                               : qk::launch_k2<8, 0>)
               : (modes == 2   ? qk::launch_k2<qk::MAXL, 2>
                  : modes == 1 ? qk::launch_k2<qk::MAXL, 1>
                               : qk::launch_k2<qk::MAXL, 0>);
  run(A, B, c, m, n, k, out_bytes, p, s);
  return (int)cudaGetLastError();
}
