// G1: HuBERT's dense layers, y = epilogue(x . W^T + b), in fp32 as 3xTF32
// on Hopper's wgmma (sm_90a).
//
// Replaces no TPU kernel: the JAX package's HuBERT (vcvits_tpu/models/
// hubert.py) runs its dense layers as flax Dense, an XLA dot. It was added
// because fp32 with TF32 off sends those products to cuBLAS's SGEMM on the
// CUDA cores (67 TFLOP/s), where they took most of a conversion request's
// device time. models/hubert.py routes through it, per encoder layer, q/k/v
// as one product over the concatenated [3C, C] weight (bias), out_proj
// (bias + residual), fc1 (bias + exact erf-GELU) and fc2 (bias + residual),
// and post_extract_proj (bias); ops/hubert_gemm.py is the wrapper.
//
// Bound, HuBERT XTRALARGE (C 1280, FFN 5120, 48 layers; 19.7 M weights a
// layer): at M rows, 2 M x 19.7 M x 48 operations, counted as three TF32
// products (3xTF32 below) at 495 TFLOP/s: 2.0 ms at 177 rows (a 3.5 s
// request), 4.9 ms at 425. The function reads the fp32 weights once a
// request, 3.77 GB, 1.13 ms at 3.35 TB/s, so both are bound by operations.
// This design reads the split hi and lo halves instead, 7.5 GB, 2.25 ms,
// which puts a mean request at the balance point.
//
// Design:
// * Precision. a = hi + lo with hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a
//   - hi). A weight is split once on the host side of the launch
//   (ops/hubert_gemm.py:prepare, cached by the module) and stored in the
//   layout below; an activation is split in registers as its fragment is
//   loaded. Each k-block of 32 takes its eight small products (lo.hi,
//   hi.lo) and then its four large ones (hi.hi) into a fresh wgmma partial
//   sum, which is added to an fp32 accumulator in registers: the tensor
//   cores truncate their fp32 adds, so no sum is chained across k-blocks
//   inside them, and the large terms meet the partial sum four times a
//   k-block instead of twelve.
// * Tiles. A block computes a 128 x 128 output tile: two consumer
//   warpgroups of 64 rows each run m64n128k8 wgmma with A from registers and
//   B (the weight's hi and lo tiles) from shared memory through a 128-byte
//   swizzled descriptor. A producer warpgroup, whose registers setmaxnreg
//   hands to the consumers (232 each, no spills), keeps a ring of 4 stages
//   full from one thread, two copies by the copy engine (TMA) a stage: the
//   weight tile (hi and lo, 32 KB, stored pre-swizzled, one bulk copy) and
//   the [128, 32] activation box through a tensor map (128-byte swizzle,
//   rows past M read as 0 and their outputs not stored). Each stage has a
//   full mbarrier (the copies' bytes) and an empty one (each consumer
//   warp's arrival). The activations were first copied a row at a time
//   (128 bulk copies a stage, 2.3x slower in all) and then by cp.async from
//   one warp (1.25x slower than the tensor map).
// * Filling 132 SMs at 50-500 rows. The grid is persistent and stream-K
//   (`Walk`): the k-blocks of the weight's column tiles, laid end to end,
//   are cut into one equal range a group of blocks, one block a row tile.
//   The blocks of a group read the same weight k-block at about the same
//   time. A block that holds a whole tile finishes it in registers; one that
//   holds a piece writes its partial sum (its rows below M) to a workspace
//   slot and counts it on the tile's counter (an integer atomic). The block
//   that brings the count to the tile's number of pieces adds the pieces in
//   their k order, runs the epilogue and resets the counter. The order of
//   the adds does not depend on which block comes last, so two runs are
//   bit-identical; there are no float atomics. ops/hubert_gemm.py:plan picks
//   the number of groups from (M, N, K).
// * Shared memory: 4 x (32 KB of weights + 16 KB of activations) + the
//   barriers and the 1 KB alignment slack, 197,712 bytes; one block an SM.
// * Measured (H100, PERF.md): 120-220 TFLOP/s counted as 3xTF32 at 177-425
//   rows, 26-52 % of the bound above; a launch also pays a fixed 8-15 us
//   (launch, fill, pieces, tail), which the 4 launches a layer repeat 48
//   times. Loading the next stage's fragments under the current products
//   was measured no faster.

#include <cuda.h>  // CUtensorMap: the driver's tensor maps, encoded through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int CONSUMERS = 256;               // two warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS + 128;     // and a producer warpgroup (one thread works)
constexpr int B_HALF = BN * BK;              // floats in one half (hi or lo) of a weight tile
constexpr int B_STAGE_BYTES = 2 * B_HALF * 4;
constexpr int A_STAGE_BYTES = BM * BK * 4;
constexpr int SMEM_BYTES = 1024 + STAGES * (B_STAGE_BYTES + A_STAGE_BYTES) + 2 * STAGES * 8 + 16;

enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

struct Params {
  CUtensorMap x;      // [M, K] in [BM, BK] boxes, 128-byte swizzled, rows past M read as 0
  const float* w;     // [N / BN][K / BK][2][BN * BK]: hi then lo, swizzled (ops/hubert_gemm.py)
  const float* bias;  // [N] or null
  const float* res;   // [M, N] (EPI_RESIDUAL)
  float* out;         // [M, N]
  float* ws;          // [2 * gridDim.x][BM * BN]: the blocks' partial tiles
  int* counters;      // [tiles], 0 between launches
  int M, N, K, epilogue;
};

using tc::smem_addr;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// The arrival that also expects `bytes` from bulk copies on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) by the copy engine,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The [BM, BK] box of `map` at (column c0, row c1) by the copy engine (TMA),
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// The consumer warpgroups' own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A wgmma descriptor of a K-major [rows][32 fp32] tile, 128-byte swizzled,
// 1024-byte aligned: 8-row groups 1024 bytes apart (SBO), the leading offset
// unused under the swizzle. Adding 2 to it moves 32 bytes (8 tf32) along K.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// An empty statement that reads and writes r: a wgmma writes its sum
// asynchronously, so no use of it may move above the wait.
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a . b: one m64n128k8 tf32 product, A from registers, B by descriptor;
// `accumulate` 0 starts d afresh (wgmma's scale-d).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The stream-K walk, shared by the producer and the consumers. The blocks
// form groups of one block per row tile (block = group * row tiles + row
// tile); group g owns the k-blocks [total * g / groups, total * (g + 1) /
// groups) of the weight's column tiles laid end to end, for each row tile,
// and `cta_of(X)` is the group owning position X. The blocks of a group
// read the same weight k-block at about the same time, so it comes from
// device memory once and from L2 for the other row tiles.
struct Walk {
  long long total;
  int grid, kb_count;
  __device__ long long start(int b) const { return total * b / grid; }
  __device__ int cta_of(long long X) const { return (int)(((X + 1) * grid - 1) / total); }
};

__device__ __forceinline__ float gelu(float v) {  // F.gelu's exact form
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
}

__global__ void __launch_bounds__(THREADS, 1) hubert_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* sB = reinterpret_cast<float*>(smem);                          // STAGES x [hi | lo]
  float* sA = reinterpret_cast<float*>(smem + STAGES * B_STAGE_BYTES);  // STAGES x [BM][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * (B_STAGE_BYTES + A_STAGE_BYTES));
  uint64_t* empty = full + STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + STAGES);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int M = p.M, N = p.N, K = p.K;
  const int mt_count = (M + BM - 1) / BM, kb_count = K / BK;
  const int mt = blockIdx.x % mt_count, group = blockIdx.x / mt_count;
  const Walk walk{(long long)(N / BN) * kb_count, (int)gridDim.x / mt_count, kb_count};
  const long long beg = walk.start(group), end = walk.start(group + 1);
  const int m0 = mt * BM, rows = min(BM, M - m0);

  if (tid >= CONSUMERS) {
    // ---- producer: one thread, two copies a stage (the weight tile, the
    // activation box); its warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long it = beg; it < end; ++it) {
        const int nt = (int)(it / kb_count), kb = (int)(it % kb_count);
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect(&full[stage], B_STAGE_BYTES + A_STAGE_BYTES);
        bulk_copy(sB + stage * 2 * B_HALF, p.w + ((size_t)nt * kb_count + kb) * 2 * B_HALF,
                  B_STAGE_BYTES, &full[stage]);
        tma_load(sA + stage * BM * BK, &p.x, kb * BK, m0, &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row_in_tile = wg * 64 + warp * 16 + g;  // and + 8

  int stage = 0;
  uint32_t phase = 0;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;

  for (long long it = beg; it < end;) {
    const int nt = (int)(it / kb_count), kb0 = (int)(it % kb_count);
    const int kb1 = (int)min((long long)kb_count, kb0 + (end - it));
    const int tile = nt * mt_count + mt, n0 = nt * BN;
    const bool first_piece = it == beg;
    it += kb1 - kb0;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      // rows row_in_tile and + 8 of the swizzled box: 16-byte chunk c of row
      // r lies at c ^ (r % 8), and r % 8 = g for both rows
      const float* a = sA + stage * BM * BK + row_in_tile * BK + q;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int c0 = ((2 * s) ^ g) * 4, c1 = ((2 * s + 1) ^ g) * 4;
        const float v[4] = {a[c0], a[8 * BK + c0], a[c1], a[8 * BK + c1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[s][i] = tc::tf32(v[i]);
          alo[s][i] = tc::tf32(v[i] - __uint_as_float(ahi[s][i]));
        }
      }
      const uint64_t dhi = b_desc(sB + stage * 2 * B_HALF);
      const uint64_t dlo = b_desc(sB + stage * 2 * B_HALF + B_HALF);
      // the small products first, then the large ones: 4 adds at the partial's
      // full size, where the tensor cores' truncation costs most
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_tf32(part, alo[s], dhi + 2 * s, s > 0);
        wgmma_tf32(part, ahi[s], dlo + 2 * s, 1);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_tf32(part, ahi[s], dhi + 2 * s, 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(part[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (kb0 != 0 || kb1 != kb_count) {
      // a piece of the tile: park it, count it; the last piece's block adds them all
      const long long t0 = (long long)nt * kb_count;
      const int c0 = walk.cta_of(t0);
      const int pieces = walk.cta_of(t0 + kb_count - 1) - c0 + 1;
      float4* mine = reinterpret_cast<float4*>(
          p.ws + (size_t)(2 * blockIdx.x + (first_piece ? 0 : 1)) * BM * BN);
      if (row_in_tile < rows) {  // rows past M are left out here and below
#pragma unroll
        for (int v = 0; v < 16; ++v)
          mine[v * CONSUMERS + tid] =
              make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
      }
      __threadfence();
      consumers_sync();
      if (tid == 0) {
        const int done = atomicAdd(&p.counters[tile], 1) + 1;
        if (done == pieces) p.counters[tile] = 0;
        *last_flag = done == pieces;
      }
      consumers_sync();
      if (!*last_flag || row_in_tile >= rows) continue;
      __threadfence();
      // pieces j >= 1 start their group's range (slot 0); piece 0 does where
      // the tile starts at its group's start
      for (int j = 0; j < pieces; ++j) {
        const int c = c0 + j;
        const int slot = 2 * (c * mt_count + mt) + (j == 0 && walk.start(c) != t0 ? 1 : 0);
        const float4* src = reinterpret_cast<const float4*>(p.ws + (size_t)slot * BM * BN);
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          const float4 t = __ldcg(src + v * CONSUMERS + tid);
          if (j == 0) {
            acc[4 * v] = t.x, acc[4 * v + 1] = t.y, acc[4 * v + 2] = t.z, acc[4 * v + 3] = t.w;
          } else {
            acc[4 * v] += t.x, acc[4 * v + 1] += t.y, acc[4 * v + 2] += t.z, acc[4 * v + 3] += t.w;
          }
        }
      }
    }

    // epilogue: thread (g, q) of warp `warp` holds rows row_in_tile (+ 8),
    // columns 8 j + 2 q (+ 1) for j < 16
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 b = p.bias ? *reinterpret_cast<const float2*>(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row_in_tile + 8 * h;
        if (row >= M) continue;
        float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (p.epilogue == EPI_GELU) {
          v0 = gelu(v0);
          v1 = gelu(v1);
        } else if (p.epilogue == EPI_RESIDUAL) {
          const float2 r = *reinterpret_cast<const float2*>(p.res + (size_t)row * N + col);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(p.out + (size_t)row * N + col) = make_float2(v0, v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the driver once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

}  // namespace

extern "C" {

// Shared memory a block of G1 takes, in bytes.
int hubert_gemm_smem_bytes() { return SMEM_BYTES; }

// out [M, N] = epilogue(x [M, K] . W^T + bias) on `grid` persistent blocks
// (groups of one block a row tile, at most one group per column tile's
// k-block); w in prepare's tiled layout; ws holds
// 2 * grid tiles of BM * BN floats; counters one int a tile, all 0. Returns
// a cudaError_t.
int hubert_gemm(const float* x, const float* w, const float* bias, const float* res, float* out,
                float* ws, int* counters, int M, int N, int K, int grid, int epilogue,
                void* stream) {
  if (M < 1 || N < BN || N % BN || K < BK || K % BK || epilogue < EPI_BIAS ||
      epilogue > EPI_RESIDUAL || (epilogue == EPI_RESIDUAL) != (res != nullptr))
    return (int)cudaErrorInvalidValue;
  const int mt_count = (M + BM - 1) / BM;
  if (grid < mt_count || grid % mt_count || grid / mt_count > (long long)(N / BN) * (K / BK))
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit, once a device (a driver call each launch
  // would cost the host more than the check)
  static bool raised[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !raised[device]) {
    err = cudaFuncSetAttribute(hubert_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) raised[device] = true;
  }
  Params p{{}, w, bias, res, out, ws, counters, M, N, K, epilogue};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {BK, BM}, unit[2] = {1, 1};
  if (encode(&p.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  hubert_gemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
