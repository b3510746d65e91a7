// K1: integer GEMM with int32 accumulation and the requantize fused on the
// accumulator, for qgemul's lossless tier.
//
// Replaces the Pallas kernel qublas_tpu/ops/pallas_gemm.py:_pallas_gemm
// (body _epilogue_kernel): there the sequential K grid axis carries the
// int32 accumulator in VMEM scratch and the last K step runs
// requantize_i32 and stores the narrow lane.  On Hopper blocks run in no
// order, so the K loop moves inside the block, the accumulator lives in
// registers, and the epilogue (csrc/requant.cuh) runs once per output and
// writes int8/int16/int32 once.  Valid only under ops/gemm.exact_plan's
// proof: every partial sum fits int32, so any summation order is exact.
//
// What bounds it on the H100: int8 tensor-core operations.  At 4096^3 the
// GEMM is 137 G int8 ops against 48 MB of operand and output traffic, far
// above the ridge point.  The int8 instantiation is therefore built the
// way Hopper reaches its tensor-core rate:
//  * both operands K-major: A [M, K] and B as Bt [N, K], the only layout
//    wgmma takes for 8-bit types.  The wrapper passes row strides, so a
//    K-major view of a stored weight costs no copy;
//  * tiles arrive by TMA (cp.async.bulk.tensor.2d, 128-byte swizzle, one
//    128-byte K row per tile row) into a ring of STAGES buffers guarded by
//    full/empty mbarriers; one producer warp keeps the copies in flight;
//  * two consumer warpgroups issue wgmma.mma_async m64n128k32 s32.s8.s8
//    on a 128 x 128 output tile, without .satfinite: the int32 accumulator
//    wraps, as int_dot_plain wraps;
//  * the epilogue parks the accumulators in shared memory (the ring is
//    free by then), requantizes them in a rolled loop with one inlined
//    qk::requant, and writes the lane in 16-byte stores;
//  * the table instantiation (LUT) stores lut[v & mask] for each
//    requantized value v: a ROM on the output's raws (and any cast after
//    it, composed into the entries), at most 256 int32 entries staged
//    once a block in the part of the ring that the int32 staging leaves
//    free, so the lookup costs one shared-memory read an output, made as
//    the store loop packs the lane, and no pass over device memory.  A
//    warp's 32 reads of random entries would share banks, so int8 entries
//    are also staged as one byte copy a lane, in banks of its own.
// TMA zero-fills boxes past the tensor's edge, so ragged M, N and K need
// no code here.  It cannot describe a row stride that is not a multiple of
// 16 bytes or a base that is not 16-byte aligned: for those the wrapper
// (ops/fused_gemm.py) hands over zero-padded copies, K rounded up to 16.
//
// The int32 instantiation (int16/int32 lanes, as
// qublas_tpu/ops/pallas_gemm.py:qgemul_fast casts them) is a shared-memory
// tiled SIMT GEMM with wrapping int32 multiply-add on row-major A and B.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

namespace {

constexpr int BM = 128;          // output rows of a block: two warpgroups
constexpr int BN = 128;          // output columns of a block
constexpr int BK = 128;          // int8 K depth of a stage: one swizzle row
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
// two blocks an SM, three stages each: one's epilogue overlaps the other's
// products (a 128 x 256 tile at one block an SM was no faster)
constexpr int MINB = 2;
constexpr int STAGES = 3;

// Shared-memory plan of the int8 kernel
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int RING = STAGES * STAGE;
constexpr int LDC = BN + 8;  // int32 staging row: 8-word skew
constexpr int EPI = BM * LDC * 4;
constexpr int DATA = RING > EPI ? RING : EPI;
// the table instantiation's entries, past the int32 staging
constexpr int LUT_MAX = 256;
// and, for int8 outputs, a byte copy of the table for each lane of a warp
constexpr int COPIES = EPI + LUT_MAX * 4;
static_assert(COPIES + LUT_MAX * 32 <= DATA, "the table must fit the ring");
static_assert(LUT_MAX <= CONSUMERS, "a consumer thread an entry");
// data, then full[STAGES] and empty[STAGES] barriers, and room to align the
// data to the 1024 bytes that the 128-byte swizzle repeats over
constexpr int SMEM = DATA + 16 * STAGES + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (inner = k, outer = row) of `map` into dst, completing
// on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// start address, leading offset 16 bytes (unused by this layout), stride
// 1024 bytes between groups of 8 rows, layout 1 = 128-byte swizzle.
// Adding 2 advances the start by 32 bytes: the next k32 slice of a row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The named barrier of the two consumer warpgroups (the producer warp has
// left by then).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// D[64 x 128] += A[64 x 32] . B[128 x 32], int8 -> int32, both operands
// K-major in shared memory (descriptors da, db); 64 accumulators a
// thread, laid out as wgmma's m64n128 D fragment.
__device__ __forceinline__ void wgmma_n128(int32_t (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int NACC>
__device__ __forceinline__ void fence_acc(int32_t (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// Four staged int32 results (16-byte aligned), each looked up in table
// (its low bits under mask) where the instantiation has one.
template <bool LUT>
__device__ __forceinline__ int4 load4(const int32_t* v, const int32_t* table,
                                      uint32_t mask) {
  int4 x = *reinterpret_cast<const int4*>(v);
  if constexpr (LUT) {
    x = make_int4(table[(uint32_t)x.x & mask], table[(uint32_t)x.y & mask],
                  table[(uint32_t)x.z & mask], table[(uint32_t)x.w & mask]);
  }
  return x;
}

// Entry v & mask of an int8 table from this lane's byte copy: entry i of
// lane l's copy lies at byte 128 (i / 4) + 4 l + i % 4 from the copies'
// start, in word 32 (i / 4) + l, so a warp's 32 reads fall in 32 banks
// whatever entries they read.
__device__ __forceinline__ uint32_t lane_byte(const uint8_t* copy, int32_t v,
                                              uint32_t mask) {
  const uint32_t i = (uint32_t)v & mask;
  return copy[((i >> 2) << 7) + (i & 3)];
}

// Store 16 bytes of the output lane at element `off` from 16 / out_bytes
// staged int32 results (16-byte aligned), wrapping each into the lane;
// the table instantiation stores their entries (int8 ones from the lane's
// byte copy).
template <bool LUT>
__device__ __forceinline__ void store16(void* C, size_t off,
                                        const int32_t* v, int out_bytes,
                                        const int32_t* table,
                                        const uint8_t* copy, uint32_t mask) {
  int4 w;
  if (out_bytes == 1) {
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = *reinterpret_cast<const int4*>(v + 4 * q);
      if constexpr (LUT) {
        word[q] = lane_byte(copy, x.x, mask) |
                  (lane_byte(copy, x.y, mask) << 8) |
                  (lane_byte(copy, x.z, mask) << 16) |
                  (lane_byte(copy, x.w, mask) << 24);
      } else {
        word[q] = ((uint32_t)x.x & 0xffu) | (((uint32_t)x.y & 0xffu) << 8) |
                  (((uint32_t)x.z & 0xffu) << 16) | ((uint32_t)x.w << 24);
      }
    }
    w = make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
  } else if (out_bytes == 2) {
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int4 x = load4<LUT>(v + 4 * q, table, mask);
      word[2 * q] = ((uint32_t)x.x & 0xffffu) | ((uint32_t)x.y << 16);
      word[2 * q + 1] = ((uint32_t)x.z & 0xffffu) | ((uint32_t)x.w << 16);
    }
    w = make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
  } else {
    w = load4<LUT>(v, table, mask);
  }
  *reinterpret_cast<int4*>(static_cast<int8_t*>(C) + off * out_bytes) = w;
}

// C[m, n] = requant(sum_k A[m, k] * Bt[n, k]) for int8 A [M, K] and Bt
// [N, K], read through the TMA maps map_a and map_bt; C [M, N] contiguous.
// With LUT, C[m, n] = lut[requant(...) & mask], mask + 1 <= LUT_MAX
// entries (lut and mask are not read without it).
template <bool LUT>
__global__ void __launch_bounds__(THREADS, MINB)
fused_gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_bt,
                     void* __restrict__ C, int M, int N, int K,
                     int out_bytes, bool vec, bool ident, qk::Rq rq,
                     const int32_t* __restrict__ lut, uint32_t mask) {
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DATA);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues the copies
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* stage = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load(stage, &map_a, kt * BK, m0, &full[s]);
        tma_load(stage + A_BYTES, &map_bt, kt * BK, n0, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64)
  const int wg = tid >> 7;
  // the table instantiation: this thread's entry, read now so that the
  // read's latency hides under the products
  [[maybe_unused]] int32_t entry = 0;
  if constexpr (LUT) {
    if ((uint32_t)tid <= mask) entry = __ldg(lut + tid);
  }
  int32_t acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* stage = smem + s * STAGE;
    const uint64_t da = smem_desc(stage + wg * 64 * BK);
    const uint64_t db = smem_desc(stage + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      wgmma_n128(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // k-tile kt - 1's products are done: free its stage
    if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: accumulators -> shared staging [BM][LDC] int32
  consumers_sync();  // both warpgroups are done reading the ring
  int32_t* cs = reinterpret_cast<int32_t*>(smem);
  // the table instantiation's entries, past the staging, and for int8
  // outputs the lanes' byte copies: warp w packs entries 32 w .. 32 w + 31
  // (its lanes' entries) four to a word and writes each word once a lane
  [[maybe_unused]] int32_t* table = reinterpret_cast<int32_t*>(smem + EPI);
  [[maybe_unused]] uint8_t* copies = smem + COPIES;
  if constexpr (LUT) {
    if ((uint32_t)tid <= mask) table[tid] = entry;
    if (out_bytes == 1) {
      const uint32_t b = (uint32_t)entry & 0xffu;
      const uint32_t quad = b | (__shfl_down_sync(~0u, b, 1) << 8) |
                            (__shfl_down_sync(~0u, b, 2) << 16) |
                            (__shfl_down_sync(~0u, b, 3) << 24);
      uint32_t* words = reinterpret_cast<uint32_t*>(copies) +
                        (tid >> 5) * 8 * 32 + (tid & 31);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        words[g * 32] = __shfl_sync(~0u, quad, 4 * g);
      }
    }
  }
  {
    const int lane = tid & 31;
    const int r = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<int2*>(cs + r * LDC + 8 * j + c) =
          make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(cs + (r + 8) * LDC + 8 * j + c) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  consumers_sync();
  if (!ident) {  // the requantize, rolled: one inlined copy of its dispatch
#pragma unroll 1
    for (int i = tid; i < BM * BN; i += CONSUMERS) {
      int32_t* p = cs + (i / BN) * LDC + i % BN;
      *p = qk::requant(*p, rq);
    }
    consumers_sync();
  }
  // the lane, 16 bytes a store where the row and its alignment allow; the
  // table instantiation looks each value up as it packs it: 4 to 16
  // independent shared-memory reads a store
  const int per = 16 / out_bytes;
  const int chunks = BN / per;
#pragma unroll 1
  for (int i = tid; i < BM * chunks; i += CONSUMERS) {
    const int r = i / chunks;
    const int c = (i % chunks) * per;
    const int gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const int32_t* src = cs + r * LDC + c;
    const size_t off = (size_t)gr * N + gc;
    if (vec && gc + per <= N) {
      store16<LUT>(C, off, src, out_bytes, table, copies + 4 * (tid & 31),
                   mask);
    } else {
      for (int e = 0; e < per && gc + e < N; ++e) {
        const int32_t v = LUT ? table[(uint32_t)src[e] & mask] : src[e];
        qk::store_lane(C, off + e, v, out_bytes);
      }
    }
  }
}

constexpr int TS = 16;  // SIMT tile: 16 x 16 outputs, 16-deep K slices

// C[m, n] = requant(sum_k A[m, k] * B[k, n]); A [M, K], B [K, N] int32.
__global__ void __launch_bounds__(TS * TS)
fused_gemm_s32_kernel(const int32_t* __restrict__ A,
                      const int32_t* __restrict__ B, void* __restrict__ C,
                      int M, int N, int K, int out_bytes, qk::Rq rq) {
  __shared__ int32_t As[TS][TS + 1];
  __shared__ int32_t Bs[TS][TS + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * TS + ty;
  const int col = blockIdx.x * TS + tx;
  int32_t acc = 0;
  for (int k0 = 0; k0 < K; k0 += TS) {
    As[ty][tx] = (row < M && k0 + tx < K) ? A[(size_t)row * K + k0 + tx] : 0;
    Bs[ty][tx] = (k0 + ty < K && col < N) ? B[(size_t)(k0 + ty) * N + col] : 0;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < TS; ++e) acc = qk::wadd(acc, qk::wmul(As[ty][e], Bs[e][tx]));
    __syncthreads();
  }
  if (row < M && col < N) {
    qk::store_lane(C, (size_t)row * N + col, qk::requant(acc, rq), out_bytes);
  }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
EncodeTiled encode_tiled() {
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

// The TMA map of an int8 matrix [rows, k], row stride ld bytes, in boxes
// of box_rows x BK with the 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int k,
                long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared memory of fused_gemm_s8_kernel<LUT>, set once a
// device.
template <bool LUT>
cudaError_t size_smem(int device) {
  static uint64_t sized = 0;  // devices whose attribute is set
  if (device < 64 && ((sized >> device) & 1)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fused_gemm_s8_kernel<LUT>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess && device < 64) sized |= (uint64_t)1 << device;
  return err;
}

}  // namespace

// int8 A [m, k] (row stride lda bytes) times Bt [n, k] (row stride ldb),
// both K-major with 16-byte aligned bases and strides.  lut: null, or the
// device's int32 table of mask + 1 entries (a power of two, at most
// LUT_MAX) that maps each requantized output's low bits to the value
// stored.  Returns a cudaError_t, -1 for arguments outside the kernel's
// range, -2 if TMA cannot describe them.
extern "C" int qk_fused_gemm_s8(int device, const void* a, long long lda,
                                const void* bt, long long ldb, void* c,
                                int m, int n, int k, int out_bytes, int d,
                                int round, int ovf, int w, int sgn,
                                const void* lut, int mask, void* stream) {
  if ((k > 0 && (lda % 16 != 0 || ldb % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(bt) % 16 != 0)) ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4) ||
      (lut != nullptr &&
       (mask < 0 || mask >= LUT_MAX || (mask & (mask + 1)) != 0))) {
    return -1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a{}, map_bt{};
  if (k > 0 && !(tensor_map(&map_a, a, m, k, lda, BM) &&
                 tensor_map(&map_bt, bt, n, k, ldb, BN))) {
    return -2;
  }
  err = lut != nullptr ? size_smem<true>(device) : size_smem<false>(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((long long)n * out_bytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  // int_dot's epilogue: requant returns the sum unchanged (shift 0, a
  // signed 32-bit wrap), so the pass is skipped
  const qk::Rq rq{d, round, ovf, w, sgn};
  const bool ident = rq.d == 0 && rq.ovf == qk::WRP_TCPL && rq.w >= 32 &&
                     rq.sgn;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* table = static_cast<const int32_t*>(lut);
  if (table != nullptr) {
    fused_gemm_s8_kernel<true><<<grid, THREADS, SMEM, s>>>(
        map_a, map_bt, c, m, n, k, out_bytes, vec, ident, rq, table,
        (uint32_t)mask);
  } else {
    fused_gemm_s8_kernel<false><<<grid, THREADS, SMEM, s>>>(
        map_a, map_bt, c, m, n, k, out_bytes, vec, ident, rq, nullptr, 0);
  }
  return (int)cudaGetLastError();
}

extern "C" int qk_fused_gemm_s32(int device, const void* a, const void* b,
                                 void* c, int m, int n, int k, int out_bytes,
                                 int d, int round, int ovf, int w, int sgn,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const qk::Rq rq{d, round, ovf, w, sgn};
  dim3 grid((n + TS - 1) / TS, (m + TS - 1) / TS);
  fused_gemm_s32_kernel<<<grid, dim3(TS, TS), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), c, m, n,
      k, out_bytes, rq);
  return (int)cudaGetLastError();
}
