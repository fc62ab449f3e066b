// One (block, dilation) pair of a HiFi-GAN MRF stage, both convolutions in
// one launch, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/mrf_pallas.py:_mrf_kernel
// (pallas_call in mrf_fused, mrf_pallas.py:134). A stage's MRF is, for each
// ResBlock1 block (kernel k) and each of its dilations d:
//   u = lrelu(conv_{k,d}(lrelu(h)) + b1)            rows outside [0,T) are 0
//   h = h + conv_{k,1}(u) + b2
// and the stage's output is the mean of the blocks' final h. The wrapper in
// ops/mrf.py makes one launch of this kernel per (block, dilation), and the
// epilogue says where the pair's result goes:
//   EPI_RES   out = res + conv2 + b2                  (h of the next pair)
//   EPI_ADD   out = out + res + conv2 + b2            (last dilation of a block)
//   EPI_MEAN  out = (out + res + conv2 + b2) * inv_n  (last dilation, last block)
// with res = in, the pair's input h. Conv inputs are rounded to the
// weights' type (fp32 or bf16) as the Pallas kernel does (`.astype(wdt)`),
// every sum is fp32, and h is fp32 between launches.
//
// Bound, one 10 s request at 48 kHz (four stages, C = 256..32, T = 7440 ..
// 476160): 126 C^2 multiply-adds per sample per stage, 737 GFLOP in all.
// bf16 weights: 0.745 ms at 989 TFLOP/s. fp32 weights: 3xTF32 below, three
// TF32 products per multiply-add, 3 x 737 GFLOP at 495 TFLOP/s = 4.47 ms,
// below the 11.0 ms of fp32 FMAs on the CUDA cores. Activation traffic: each
// pair reads its input (with a halo) and its residual and writes h once,
// about 20 fp32 passes over [T, C] per stage, 0.9 ms at 3.35 TB/s.
//
// Design:
// * A block owns `rows` conv1 rows of one batch row and all C channels; of
//   its conv2 rows it keeps the first rows - (k-1) (the output tile). It
//   stages its input rows with the halo (k-1)/2*d + (k-1)/2 on each side,
//   lrelu'd and rounded to the weight type, zeros outside [0,T); computes
//   conv1 into a shared-memory u tile (bias, lrelu, rounded, and 0 on rows
//   outside [0,T): the plain version pads u with zeros, so lrelu(b1) must
//   not leak there); then conv2 from that tile, and the epilogue. u never
//   leaves the chip: 9 launches per stage instead of 18 single convs.
// * A warp owns a 64-row x 32-channel tile; C/32 warps span the channels
//   and 8/(C/32) the rows, so rows = 64 * 8 / (C/32) (64 at C = 256, 512 at
//   C = 32). A tap is a shift of m*d rows, not a multiple of 8, so a
//   swizzled wgmma descriptor cannot point at a shifted A tile: A comes from
//   an unswizzled row-major tile, its row stride padded against bank
//   conflicts, at any row offset (ldmatrix for bf16, 32-bit loads for
//   tf32), into mma.sync (m16n8k16 bf16, m16n8k8 tf32) with fp32
//   accumulators.
// * fp32 weights: 3xTF32. Each operand splits as a = hi + lo with hi =
//   cvt.rna.tf32(a), as its fragment is loaded; a weight's lo is rounded to
//   tf32 too, an activation's is passed as fp32 and the tensor cores drop
//   its low 13 bits (one conversion fewer per value, 6 % faster at the same
//   error on the H100). The sum takes lo*hi + hi*lo + hi*hi: about 2^-21
//   relative per product, where one TF32 product is off by 2^-11. Each
//   weight tile's products go into a partial sum added to the accumulator
//   in fp32 (see mma_step). bf16: the inputs are already bf16, so each
//   product is exact and only the order of the fp32 sums changes.
// * Weights (126 C^2 values a stage, 33 MB fp32 at C = 256) stay in L2 and
//   stream through a cp.async ring of [KS input channels x C] tiles, one per
//   (tap, channel slice), the next loading while one is multiplied: bf16 64
//   channels (32 at C = 32), 3 deep, two blocks an SM (at most 128
//   registers a thread); fp32 32 channels, 2 deep.
// * Shared memory: the input tile (reused for u) plus the ring, at most
//   186 KB (fp32, C = 256, k = 11, d = 5); `mrf_plan` below (and
//   ops/mrf.py:plan) refuses a size above the 227 KB a block can have.
// * What bounds it as built (H100, chip_smoke.py's K1 phase, PERF.md): every
//   block streams all of a pair's weights from L2, so at C = 256 and 128
//   that traffic (about 2 GB a stage in bf16) costs about as much as the
//   products; at C = 64 and 32 the activation traffic does. fp32 spends
//   most of its time in the three mma.sync per product and the splits, one
//   block an SM (about 240 registers). wgmma (A from registers, the split
//   weights in shared memory) was measured no faster while each block still
//   syncs once per weight tile; weights shared across a thread-block
//   cluster (TMA multicast) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 4, NT = 4;  // a warp's 16x8 mma tiles: 64 rows x 32 channels
constexpr int MAX_SMEM = 232448;

enum Epilogue { EPI_RES = 0, EPI_ADD = 1, EPI_MEAN = 2 };

// The weight ring: depth, and input channels per tile.
__host__ __device__ constexpr int stages_of(bool bf16) { return bf16 ? 3 : 2; }
__host__ __device__ inline int ks_of(int C, bool bf16) { return bf16 && C % 64 == 0 ? 64 : 32; }
__host__ __device__ inline int x_stride(int C, bool bf16) { return C + (bf16 ? 8 : 4); }
__host__ __device__ inline int w_stride(int C) { return C + 8; }

// Bytes from the start of shared memory to the weight ring: the input tile,
// rounded up to 128.
__host__ __device__ inline long long ring_offset(long long span, int C, bool bf16) {
  return (span * x_stride(C, bf16) * (bf16 ? 2 : 4) + 127) / 128 * 128;
}

// The launch's shape: threads, conv1 rows, shared-memory bytes; false where
// the kernel does not take the size. ops/mrf.py:plan mirrors this.
bool plan(int C, int K, int dil, bool bf16, int* threads, int* rows, int* smem) {
  if (C % 32 != 0 || C < 32 || C > 256 || K < 1 || K % 2 == 0 || dil < 1) return false;
  const int wn = C / 32, wm = 8 / wn;
  *threads = 32 * wn * wm;
  *rows = 64 * wm;
  if (K - 1 >= *rows) return false;
  const long long span = *rows + (long long)(K - 1) * dil;  // >= rows + K - 1 for u
  const long long bytes = ring_offset(span, C, bf16) + (long long)stages_of(bf16) *
                                                           ks_of(C, bf16) * w_stride(C) *
                                                           (bf16 ? 2 : 4);
  if (bytes > MAX_SMEM) return false;
  *smem = (int)bytes;
  return true;
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

struct Warp {
  int lane, r0, n0;  // lane; the warp's first tile row and output channel
};

// acc += A[r0 + shift .. +64, k0 .. k0+KSX] @ W[0..KSX, n0 .. n0+32], A and W
// row-major in shared memory with row strides xs and ws. 3xTF32: the tile's
// products go into a fresh partial sum that is then added to acc in fp32.
// The tensor cores' fp32 adds truncate, and summed straight into acc over
// every tile that bias grows with the depth (6e-5 x RMS at C = 256, k = 11,
// on the H100); within one tile's partial sum it stays near 2^-23.
template <int KSX>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const float* a, int xs,
                                         const float* w, int ws, int shift, int k0,
                                         const Warp& wp) {
  const int g = wp.lane >> 2, q = wp.lane & 3;
  float part[MT][NT][4];
#pragma unroll
  for (int kk = 0; kk < KSX / 8; ++kk) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* p = w + (8 * kk + q) * ws + wp.n0 + nt * 8 + g;
      split(p[0], bh[nt][0], bl[nt][0]);
      split(p[4 * ws], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = a + (wp.r0 + mt * 16 + shift + g) * xs + k0 + 8 * kk + q;
      const float v[4] = {p[0], p[8 * xs], p[4], p[8 * xs + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // lo left in fp32: the tensor cores drop its low 13 bits
        ah[i] = tf32(v[i]);
        al[i] = __float_as_uint(v[i] - __uint_as_float(ah[i]));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (kk == 0)
          mma_tf32_zero(part[mt][nt], al, bh[nt]);
        else
          mma_tf32(part[mt][nt], al, bh[nt]);
        mma_tf32(part[mt][nt], ah, bl[nt]);
        mma_tf32(part[mt][nt], ah, bh[nt]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

template <int KSX>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const __nv_bfloat16* a, int xs,
                                         const __nv_bfloat16* w, int ws, int shift, int k0,
                                         const Warp& wp) {
#pragma unroll
  for (int kk = 0; kk < KSX; kk += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t r[4];
      ldsm_x4_trans(r, w + (kk + (wp.lane & 15)) * ws + wp.n0 + 16 * j + (wp.lane >> 4) * 8);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      ldsm_x4(af, a + (wp.r0 + mt * 16 + shift + (wp.lane & 15)) * xs + k0 + kk +
                      (wp.lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, b[nt]);
    }
  }
}

// Tile `it` of w [K, C, C] (tap it / (C/KSX), input channels (it % (C/KSX))
// * KSX .. + KSX, all output channels) into a ring slot, with cp.async.
template <int KSX, typename WT>
__device__ __forceinline__ void load_w_tile(WT* slot, const WT* w, int it, int C) {
  constexpr int PER = 16 / sizeof(WT);
  const int ns = C / KSX, m = it / ns, s = it - m * ns;
  const WT* src = w + ((size_t)m * C + s * KSX) * C;
  const int per_row = C / PER, ws = w_stride(C);
  for (int i = threadIdx.x; i < KSX * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * PER;
    cp_async16(slot + r * ws + c, src + (size_t)r * C + c);
  }
}

template <int KSX, int STAGES, typename WT>
__device__ __forceinline__ void prefetch(WT* ring, const WT* w, int C, int K) {
  const int n_it = K * (C / KSX), tile = KSX * w_stride(C);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_it) load_w_tile<KSX>(ring + it * tile, w, it, C);
    cp_commit();
  }
}

// acc = sum over taps m and input channels of A[row + m*step, ci] w[m, ci, :],
// the weight tiles streamed through the ring (its first STAGES-1 tiles
// already issued by `prefetch`).
template <int KSX, int STAGES, typename WT>
__device__ __forceinline__ void conv(float (&acc)[MT][NT][4], const WT* a, int xs, int step,
                                     WT* ring, const WT* w, int C, int K, const Warp& wp) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int ns = C / KSX, n_it = K * ns, tile = KSX * w_stride(C), ws = w_stride(C);
  for (int it = 0; it < n_it; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int next = it + STAGES - 1;
    if (next < n_it) load_w_tile<KSX>(ring + (next % STAGES) * tile, w, next, C);
    cp_commit();
    const int m = it / ns;
    mma_step<KSX>(acc, a, xs, ring + (it % STAGES) * tile, ws, m * step, (it - m * ns) * KSX,
                  wp);
  }
}

template <typename WT, int KSX>
__global__ void __launch_bounds__(256, sizeof(WT) == 2 ? 2 : 1)  // bf16: two blocks an SM
mrf_pair_kernel(const float* __restrict__ in, const WT* __restrict__ w1,
                const WT* __restrict__ b1, const WT* __restrict__ w2, const WT* __restrict__ b2,
                float* __restrict__ out, int T, int C, int K, int dil, int rows, int epi,
                float inv_n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool bf16 = sizeof(WT) == 2;
  constexpr int STAGES = stages_of(bf16);
  const int xs = x_stride(C, bf16);
  const int p2 = (K - 1) / 2, p1 = p2 * dil;
  const int span = rows + (K - 1) * dil;
  WT* xt = reinterpret_cast<WT*>(smem_raw);  // [span][xs] the input tile, then u
  WT* ring = reinterpret_cast<WT*>(smem_raw + ring_offset(span, C, bf16));  // [STAGES][KSX][ws]
  const int out_rows = rows - (K - 1);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * out_rows;
  const float* inb = in + (size_t)b * T * C;

  const int warp = threadIdx.x >> 5, wn = C / 32;
  const Warp wp{(int)(threadIdx.x & 31), (warp / wn) * 64, (warp % wn) * 32};
  const int g = wp.lane >> 2, q = wp.lane & 3;

  prefetch<KSX, STAGES>(ring, w1, C, K);
  // input rows t0 - p2 - p1 .. : lrelu, rounded to WT, zeros outside [0,T)
  // (UNROLL loads in flight a thread before their stores)
  constexpr int UNROLL = 8;
  const int c4 = C / 4, n4 = span * c4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += UNROLL * blockDim.x) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x, r = i / c4, t = t0 - p2 - p1 + r;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4 && t >= 0 && t < T)
        v[u] = *reinterpret_cast<const float4*>(inb + (size_t)t * C + (i - r * c4) * 4);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x, r = i / c4;
      if (i < n4)
        store4(xt + r * xs + (i - r * c4) * 4, make_float4(lrelu(v[u].x), lrelu(v[u].y),
                                                          lrelu(v[u].z), lrelu(v[u].w)));
    }
  }

  float acc[MT][NT][4];
  conv<KSX, STAGES>(acc, xt, xs, dil, ring, w1, C, K, wp);
  __syncthreads();  // every warp is done with the input tile and the ring
  prefetch<KSX, STAGES>(ring, w2, C, K);

  // u row r is time t0 - p2 + r; rows outside [0,T) are 0, and so are the
  // rows past `rows` that only the discarded conv2 rows read
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wp.r0 + mt * 16 + g + 8 * h, t = t0 - p2 + r;
      const bool valid = t >= 0 && t < T;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wp.n0 + nt * 8 + 2 * q;
        float v0 = lrelu(acc[mt][nt][2 * h] + to_float(b1[col]));
        float v1 = lrelu(acc[mt][nt][2 * h + 1] + to_float(b1[col + 1]));
        store2(xt + r * xs + col, valid ? v0 : 0.f, valid ? v1 : 0.f);
      }
    }
  for (int i = threadIdx.x; i < (K - 1) * c4; i += blockDim.x) {
    const int r = rows + i / c4, c = (i % c4) * 4;
    store4(xt + r * xs + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }

  conv<KSX, STAGES>(acc, xt, xs, 1, ring, w2, C, K, wp);

  // a row group's residual and running total loaded before any store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float2 res[2][NT], prev[2][NT];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = wp.r0 + mt * 16 + g + 8 * h, t = t0 + j;
      const bool keep = j < out_rows && t < T;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const size_t o = ((size_t)b * T + t) * C + wp.n0 + nt * 8 + 2 * q;
        res[h][nt] = keep ? *reinterpret_cast<const float2*>(in + o) : make_float2(0.f, 0.f);
        prev[h][nt] = keep && epi != EPI_RES ? *reinterpret_cast<const float2*>(out + o)
                                             : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = wp.r0 + mt * 16 + g + 8 * h, t = t0 + j;
      if (j >= out_rows || t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wp.n0 + nt * 8 + 2 * q;
        float v0 = acc[mt][nt][2 * h] + to_float(b2[col]) + res[h][nt].x + prev[h][nt].x;
        float v1 = acc[mt][nt][2 * h + 1] + to_float(b2[col + 1]) + res[h][nt].y + prev[h][nt].y;
        if (epi == EPI_MEAN) {
          v0 *= inv_n;
          v1 *= inv_n;
        }
        *reinterpret_cast<float2*>(out + ((size_t)b * T + t) * C + col) = make_float2(v0, v1);
      }
    }
  }
}

template <typename WT, int KSX>
cudaError_t launch(const void* in, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int B, int T, int C, int K, int dil, int rows,
                   int epi, float inv_n, cudaStream_t stream) {
  int threads, want_rows, smem;
  if (!plan(C, K, dil, sizeof(WT) == 2, &threads, &want_rows, &smem) || rows != want_rows)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mrf_pair_kernel<WT, KSX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int out_rows = rows - (K - 1);
  dim3 grid((T + out_rows - 1) / out_rows, B);
  mrf_pair_kernel<WT, KSX><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(in), static_cast<const WT*>(w1), static_cast<const WT*>(b1),
      static_cast<const WT*>(w2), static_cast<const WT*>(b2), static_cast<float*>(out), T, C, K,
      dil, rows, epi, inv_n);
  return cudaGetLastError();
}

}  // namespace

// The launch shape for (C, K, dil, weight type): threads, conv1 rows a block
// and dynamic shared-memory bytes. Returns 0, or cudaErrorInvalidValue where
// the kernel does not take the size.
extern "C" int mrf_plan(int C, int K, int dil, int bf16, int* threads, int* rows, int* smem) {
  return plan(C, K, dil, bf16 != 0, threads, rows, smem) ? 0 : (int)cudaErrorInvalidValue;
}

// Plain C entry point (bound with ctypes): one (block, dilation) pair.
// Device pointers, all contiguous and 16-byte aligned:
//   in: float32 [B, T, C], the pair's input h and its residual
//   out: float32 [B, T, C], not `in`; read as well for EPI_ADD / EPI_MEAN
//   w1, w2: [K, C, C] as (tap, in channel, out channel); b1, b2: [C]; all
//   float32 (bf16 == 0) or bfloat16 (bf16 == 1)
// `rows` must be mrf_plan's. Returns the cudaError_t of the launch.
extern "C" int mrf_pair(const void* in, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int B, int T, int C, int K, int dil, int rows,
                        int epi, float inv_n, int bf16, void* stream) {
  if (in == out || B < 1 || T < 1 || epi < EPI_RES || epi > EPI_MEAN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return (int)launch<float, 32>(in, w1, b1, w2, b2, out, B, T, C, K, dil, rows, epi, inv_n, s);
  if (ks_of(C, true) == 64)
    return (int)launch<__nv_bfloat16, 64>(in, w1, b1, w2, b2, out, B, T, C, K, dil, rows, epi,
                                          inv_n, s);
  return (int)launch<__nv_bfloat16, 32>(in, w1, b1, w2, b2, out, B, T, C, K, dil, rows, epi,
                                        inv_n, s);
}
