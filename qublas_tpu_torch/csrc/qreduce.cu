// K3: the layered tree reduce (Qreduce) with per-layer requantization.
//
// Replaces qublas_tpu/ops/reduce.py:_qreduce_pallas, a Pallas kernel that
// loads an (n, BT) tile with the reduction axis first, folds all log2(n)
// layers in VMEM (each pair v[2i] + v[2i+1] requantized into the layer's
// format) and writes one row; Mosaic limited it to power-of-two n and
// batches that are multiples of 128.
//
// Here each output runs tree_fold.cuh's schedule, with a load of the input
// (int8/int16/int32, widened to int32) in place of a product: blocks of
// leaves folded in registers, a binary-carry slot stack over blocks, and
// the planner's drain over the ragged right edge.  Any aligned run of 2^j
// leaves that ends within n is one node of the reference's tree (its
// pairing (2i, 2i+1) per layer, odd tails carried up), so a block may be
// any power of two dividing n.  That is the reference's pairing for any n
// and any batch.  Two differences from the GEMM's tree, both settled by
// the planner (ops/reduce.py:ReducePlan): a tail convert between equal
// formats is left out of the drain (qcast leaves such raws as they are),
// and there is no final requantize.
//
// The tensor is read in place as [outer, n, inner], by one of three
// kernels (ops/reduce.py:k3_route picks it):
//   * inner > 1 (e.g. the layered GEMM's [m, k, n] over k): the columns
//     kernel, a thread an output (qreduce.cuh);
//   * inner == 1 and 32 | n (e.g. BASELINE config 2's [4096, 1024]): the
//     warp kernel, a warp a row (qreduce.cuh).  A chunk of 32 S leaves is
//     a block: each lane loads S contiguous leaves, up to 32 bytes, and
//     folds them in registers, five shuffle levels fold the lanes;
//   * inner == 1 otherwise: a thread a row (below), rows staged through
//     shared memory.  A warp's chunk needs 32 | n to be a node of the tree,
//     and a row of blocks smaller than 32 has too little work for a warp.
//
// What bounds it: int32 ALU work, one add and one requantize (about 5-15
// operations, by the modes) per input element, against one 1-4 byte load:
// operations at config 2's int8 rows, bytes at the layered GEMM's int32
// columns (see PERF.md for the count at the main-path shapes).  Two
// things keep the ALU work near that count.  Plans whose merges round and
// overflow with a pair of K3_MODES (one pair at level 0, one above it;
// ops/reduce.py:k3_modes) take instantiations with those modes fixed at
// compile time at the main paths' shapes (qreduce_modes_<M>.cu), so each
// requantize is a few instructions, not the 7 x 5 mode dispatch; and the
// warp kernel's 32 lanes share a row, so a config-2 row is 32 short
// chains, not one long one.

#include <cuda_runtime.h>

#include <cstdint>

#include "qreduce.cuh"

namespace {

using qk::Fold;
using qk::Shape;

constexpr int ROWS = 32;   // thread kernel: one warp, one row per thread
constexpr int CHUNK = 64;  // elements of each row staged per step (16 | it)
constexpr int BATCH = 16;  // staging loads a lane keeps in flight

// Stage rows [row0, row0 + rows) x [c0, c0 + width) of x into the tile:
// consecutive lanes read consecutive elements of a row, BATCH loads in
// flight per lane before their stores.
template <typename T>
__device__ __forceinline__ void stage(int32_t (&tile)[ROWS][CHUNK + 1],
                                      const T* __restrict__ x,
                                      long long row0, int rows, long long n,
                                      long long c0, int width, int lane) {
#pragma unroll
  for (int j0 = 0; j0 < CHUNK; j0 += BATCH) {
    int32_t buf[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = lane + (j0 + j) * ROWS;
      const int r = e / CHUNK;
      const int q = e % CHUNK;
      buf[j] = r < rows && q < width
                   ? (int32_t)__ldg(x + (size_t)(row0 + r) * n + c0 + q)
                   : 0;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int e = lane + (j0 + j) * ROWS;
      tile[e / CHUNK][e % CHUNK] = buf[j];
    }
  }
}

template <int LOG_BLK, int TOP>
__global__ void __launch_bounds__(ROWS)
qreduce_rows(const void* __restrict__ X, void* __restrict__ Y,
             long long outer, long long n, int in_bytes, int out_bytes,
             const Fold f) {
  constexpr int BLK = 1 << LOG_BLK;
  __shared__ int32_t tile[ROWS][CHUNK + 1];  // +1: conflict-free columns
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, outer - row0);

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;
  int t = 0;
  for (long long c0 = 0; c0 < n; c0 += CHUNK) {
    // a multiple of BLK, since BLK divides both n and CHUNK
    const int width = (int)min((long long)CHUNK, n - c0);
    if (in_bytes == 1) {
      stage(tile, static_cast<const int8_t*>(X), row0, rows, n, c0, width,
            lane);
    } else if (in_bytes == 2) {
      stage(tile, static_cast<const int16_t*>(X), row0, rows, n, c0, width,
            lane);
    } else {
      stage(tile, static_cast<const int32_t*>(X), row0, rows, n, c0, width,
            lane);
    }
    __syncwarp();
    if (lane < rows) {
      for (int c = 0; c < width; c += BLK, ++t) {
        int32_t v[BLK];
#pragma unroll
        for (int q = 0; q < BLK; ++q) v[q] = tile[lane][c + q];
        qk::push<LOG_BLK, TOP>(slot, t, qk::fold_block<LOG_BLK>(v, f), f);
      }
    }
    __syncwarp();
  }
  if (lane < rows) {
    qk::store_lane(Y, row0 + lane, qk::drain<LOG_BLK, TOP>(slot, f),
                   out_bytes);
  }
}

int bit_length(long long v) {
  int b = 0;
  while (b < 63 && (v >> b) != 0) ++b;
  return b;
}

// The thread kernel or the columns kernel with modes read at run time.
template <int LOG_BLK>
void launch_any(bool deep, const Shape& a, const Fold& f, cudaStream_t s) {
  if (a.inner == 1) {
    const unsigned grid = (unsigned)((a.outer + ROWS - 1) / ROWS);
    if (deep) {
      qreduce_rows<LOG_BLK, qk::MAXL><<<grid, ROWS, 0, s>>>(
          a.x, a.y, a.outer, a.n, a.in_bytes, a.out_bytes, f);
    } else {
      qreduce_rows<LOG_BLK, 16><<<grid, ROWS, 0, s>>>(
          a.x, a.y, a.outer, a.n, a.in_bytes, a.out_bytes, f);
    }
  } else {
    (deep ? qk::launch_cols<LOG_BLK, qk::MAXL, 0>
          : qk::launch_cols<LOG_BLK, 16, 0>)(a, f, s);
  }
}

// The warp kernel with modes read at run time, S = 2^LOG_S leaves a lane.
template <typename T, int LOG_S>
void launch_warp_any(bool deep, const Shape& a, const Fold& f,
                     cudaStream_t s) {
  (deep ? qk::launch_warp<T, LOG_S, qk::MAXL, 0>
        : qk::launch_warp<T, LOG_S, qk::WARP_TOP, 0>)(a, f, s);
}

template <typename T>
void launch_warp_lanes(int lanes, bool deep, const Shape& a, const Fold& f,
                       cudaStream_t s) {
  switch (lanes) {
    case 1: launch_warp_any<T, 0>(deep, a, f, s); break;
    case 2: launch_warp_any<T, 1>(deep, a, f, s); break;
    case 4: launch_warp_any<T, 2>(deep, a, f, s); break;
    case 8: launch_warp_any<T, 3>(deep, a, f, s); break;
    case 16:
      if constexpr (sizeof(T) <= 2) launch_warp_any<T, 4>(deep, a, f, s);
      break;
    default:
      if constexpr (sizeof(T) == 1) launch_warp_any<T, 5>(deep, a, f, s);
      break;
  }
}

// Whether every merge of the plan rounds and overflows with K3_MODES[modes]
// (the drain's converts are merges' requantizes).
bool modes_match(const Fold& f, int levels, int modes) {
  if (modes == 0) return true;
  if (modes < 0 || modes >= qk::K3_NMODES) return false;
  for (int l = 0; l < levels; ++l) {
    const int p = l == 0 ? 0 : 2;
    if (f.merge[l].round != qk::K3_MODES[modes][p] ||
        f.merge[l].ovf != qk::K3_MODES[modes][p + 1]) {
      return false;
    }
  }
  return true;
}

}  // namespace

// x: [outer, n, inner] contiguous, in_bytes per element; y: [outer, inner],
// out_bytes per element.  params (host int32), as
// qublas_tpu_torch/ops/reduce.py:ReducePlan.kernel_params writes them:
//   log_blk, levels, merge[levels][5], ndrain, (op, level)[ndrain]
// modes indexes K3_MODES (ops/reduce.py:k3_modes); lanes is the warp
// kernel's S (ops/reduce.py:k3_route), 0 for the other two kernels.
// Returns a cudaError_t, or -1 for parameters outside the kernels' range.
extern "C" int qk_qreduce(int device, const void* x, void* y,
                          long long outer, long long n, long long inner,
                          int in_bytes, int out_bytes, const int* params,
                          int modes, int lanes, void* stream) {
  Fold f{};
  const int log_blk = params[0];
  const int levels = params[1];
  const long long word = (long long)lanes * in_bytes;
  if (qk::read_fold(params + 1, &f) == nullptr || log_blk < 0 ||
      log_blk > 4 || n < 2 || (n & ((1LL << log_blk) - 1)) != 0 ||
      (n >> log_blk) >= (1LL << 31) || outer < 1 || inner < 1 ||
      (in_bytes != 1 && in_bytes != 2 && in_bytes != 4) ||
      !modes_match(f, levels, modes) ||
      (outer + qk::WARP_ROWS - 1) / qk::WARP_ROWS >= (1LL << 31) ||
      (outer * inner + qk::COLS_THREADS - 1) / qk::COLS_THREADS >=
          (1LL << 31)) {
    return -1;
  }
  if (lanes != 0 &&
      (inner != 1 || lanes < 0 || (lanes & (lanes - 1)) != 0 || word > 32 ||
       n % (32LL * lanes) != 0 ||
       reinterpret_cast<uintptr_t>(x) % (uintptr_t)(word < 16 ? word : 16) !=
           0)) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape a{x, y, outer, n, inner, in_bytes, out_bytes};
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes != 0) {
    const bool deep = bit_length(n / (32LL * lanes)) > qk::WARP_TOP;
    if (modes != 0 && in_bytes == 1 && lanes == 32 && !deep) {
      (modes == 1 ? qk::launch_warp<int8_t, 5, qk::WARP_TOP, 1>
                  : qk::launch_warp<int8_t, 5, qk::WARP_TOP, 2>)(a, f, s);
    } else if (in_bytes == 1) {
      launch_warp_lanes<int8_t>(lanes, deep, a, f, s);
    } else if (in_bytes == 2) {
      launch_warp_lanes<int16_t>(lanes, deep, a, f, s);
    } else {
      launch_warp_lanes<int32_t>(lanes, deep, a, f, s);
    }
    return (int)cudaGetLastError();
  }
  const bool deep = bit_length(n >> log_blk) > 16;
  if (modes != 0 && inner > 1 && log_blk == 4 && !deep) {
    (modes == 1 ? qk::launch_cols<4, 16, 1>
                : qk::launch_cols<4, 16, 2>)(a, f, s);
    return (int)cudaGetLastError();
  }
  switch (log_blk) {
    case 0: launch_any<0>(deep, a, f, s); break;
    case 1: launch_any<1>(deep, a, f, s); break;
    case 2: launch_any<2>(deep, a, f, s); break;
    case 3: launch_any<3>(deep, a, f, s); break;
    default: launch_any<4>(deep, a, f, s); break;
  }
  return (int)cudaGetLastError();
}
