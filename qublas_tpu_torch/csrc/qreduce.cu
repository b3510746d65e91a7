// K3: the layered tree reduce (Qreduce) with per-layer requantization.
//
// Replaces qublas_tpu/ops/reduce.py:_qreduce_pallas, a Pallas kernel that
// loads an (n, BT) tile with the reduction axis first, folds all log2(n)
// layers in VMEM (each pair v[2i] + v[2i+1] requantized into the layer's
// format) and writes one row; Mosaic limited it to power-of-two n and
// batches that are multiples of 128.
//
// Here one thread owns one output element and runs tree_fold.cuh's
// schedule, with a load of the input (int8/int16/int32, widened to int32)
// in place of a product: blocks of BLK = the largest power of two dividing
// n (at most 16) folded in registers, a binary-carry slot stack over
// blocks, and the planner's drain over the ragged right edge.  That is the
// reference's pairing for any n and any batch.  Two differences from the
// GEMM's tree, both settled by the planner (ops/reduce.py:ReducePlan): a
// tail convert between equal formats is left out of the drain (qcast
// leaves such raws as they are), and there is no final requantize.
//
// The tensor is read in place as [outer, n, inner]:
//   * inner > 1 (e.g. the layered GEMM's [m, k, n] over k): neighbouring
//     threads own neighbouring i, so each load of a warp is coalesced;
//   * inner == 1 (the last axis, e.g. BASELINE config 2's [4096, 1024]):
//     rows lie n elements apart, so a warp owns 32 rows and stages them
//     CHUNK elements at a time through shared memory, read along the row.
//
// What bounds it: int32 ALU work, one add and one requantize (about 5-15
// operations, by the modes) per input element, against one 1-4 byte load:
// compute-bound (see PERF.md for the count at the main-path shapes).

#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"
#include "tree_fold.cuh"

namespace {

constexpr int ROWS = 32;   // rows kernel: one warp, one row per thread
constexpr int CHUNK = 64;  // elements of each row staged per step (16 | it)
constexpr int BATCH = 16;  // staging loads a lane keeps in flight
constexpr int COLS_THREADS = 256;

template <int LOG_BLK, int TOP>
__global__ void __launch_bounds__(COLS_THREADS)
qreduce_cols(const void* __restrict__ X, void* __restrict__ Y,
             long long outer, long long n, long long inner, int in_bytes,
             int out_bytes, const qk::Fold f) {
  constexpr int BLK = 1 << LOG_BLK;
  const long long idx = (long long)blockIdx.x * COLS_THREADS + threadIdx.x;
  if (idx >= outer * inner) return;
  const long long o = idx / inner;
  const size_t base = (size_t)o * n * inner + (size_t)(idx - o * inner);
  const int nblocks = (int)(n >> LOG_BLK);

  int32_t slot[TOP];
#pragma unroll
  for (int l = 0; l < TOP; ++l) slot[l] = 0;
  for (int t = 0; t < nblocks; ++t) {
    int32_t v[BLK];
#pragma unroll
    for (int q = 0; q < BLK; ++q) {
      const size_t kk = ((size_t)t << LOG_BLK) + q;
      v[q] = qk::load_lane(X, base + kk * inner, in_bytes);
    }
    qk::push<LOG_BLK, TOP>(slot, t, qk::fold_block<LOG_BLK>(v, f), f);
  }
  qk::store_lane(Y, idx, qk::drain<LOG_BLK, TOP>(slot, f), out_bytes);
}

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
             const qk::Fold f) {
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

// One launch's tensors: x [outer, n, inner] and y [outer, inner].
struct Shape {
  const void* x;
  void* y;
  long long outer, n, inner;
  int in_bytes, out_bytes;
};

template <int LOG_BLK, int TOP>
void launch(const Shape& a, const qk::Fold& f, cudaStream_t s) {
  if (a.inner == 1) {
    const long long grid = (a.outer + ROWS - 1) / ROWS;
    qreduce_rows<LOG_BLK, TOP><<<(unsigned)grid, ROWS, 0, s>>>(
        a.x, a.y, a.outer, a.n, a.in_bytes, a.out_bytes, f);
  } else {
    const long long grid =
        (a.outer * a.inner + COLS_THREADS - 1) / COLS_THREADS;
    qreduce_cols<LOG_BLK, TOP><<<(unsigned)grid, COLS_THREADS, 0, s>>>(
        a.x, a.y, a.outer, a.n, a.inner, a.in_bytes, a.out_bytes, f);
  }
}

template <int LOG_BLK>
void launch_top(int top, const Shape& a, const qk::Fold& f,
                cudaStream_t s) {
  if (top <= 16) {
    launch<LOG_BLK, 16>(a, f, s);
  } else {
    launch<LOG_BLK, qk::MAXL>(a, f, s);
  }
}

}  // namespace

// x: [outer, n, inner] contiguous, in_bytes per element; y: [outer, inner],
// out_bytes per element.  params (host int32), as
// qublas_tpu_torch/ops/reduce.py:ReducePlan.kernel_params writes them:
//   log_blk, levels, merge[levels][5], ndrain, (op, level)[ndrain]
// Returns a cudaError_t, or -1 for parameters outside the kernel's range.
extern "C" int qk_qreduce(int device, const void* x, void* y,
                          long long outer, long long n, long long inner,
                          int in_bytes, int out_bytes, const int* params,
                          void* stream) {
  qk::Fold f{};
  const int log_blk = params[0];
  if (qk::read_fold(params + 1, &f) == nullptr || log_blk < 0 ||
      log_blk > 4 || n < 2 || (n & ((1LL << log_blk) - 1)) != 0 ||
      (n >> log_blk) >= (1LL << 31) || outer < 1 || inner < 1 ||
      (outer + ROWS - 1) / ROWS >= (1LL << 31) ||
      (outer * inner + COLS_THREADS - 1) / COLS_THREADS >= (1LL << 31)) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long nblocks = n >> log_blk;
  int top = 1;
  while (top < 31 && (nblocks >> top) != 0) ++top;  // bit_length(nblocks)
  const Shape a{x, y, outer, n, inner, in_bytes, out_bytes};
  auto s = static_cast<cudaStream_t>(stream);
  switch (log_blk) {
    case 0: launch_top<0>(top, a, f, s); break;
    case 1: launch_top<1>(top, a, f, s); break;
    case 2: launch_top<2>(top, a, f, s); break;
    case 3: launch_top<3>(top, a, f, s); break;
    default: launch_top<4>(top, a, f, s); break;
  }
  return (int)cudaGetLastError();
}
