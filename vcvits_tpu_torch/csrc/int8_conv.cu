// The dynamic W8A8 int8 convolution of the quantized decoder, on Hopper's
// int8 tensor cores (sm_90a): Q1 `int8_conv1d` and Q2 `row_absmax`.
//
// No Pallas kernel stands behind these two: the JAX package runs its int8
// decoder convolution as an XLA conv_general_dilated of int8 operands with
// int32 accumulation (vcvits_tpu/ops/int8_conv.py:int8_conv1d), and PyTorch
// has no int8 convolution on CUDA. The function (ops/int8_conv.py holds the
// plain version, and the order of its float operations is part of it):
//   act(x)      = x, or leaky_relu(x, slope) rounded to x's type
//   a_scale[b]  = max(max |act(x[b])| over all T and C, 1e-12) / 127  (Q2, then Q1)
//   xq          = clip(rint(float(act(x)) / a_scale[b]), -127, 127)    (IEEE divide)
//   acc[b,t,o]  = sum over taps j and inputs i of xq[b, t - pad_lo + j*dil, i] * w[j, o, i]
//                 (rows outside [0, T) are 0), exact in int32
//   y[b,t,o]    = float(acc) * (a_scale[b] * w_scale[o]) + bias[o], in float32
//                 (no contraction into an FMA), then rounded to x's type
// w (int8 codes) and w_scale come quantized per output column from the
// wrapper, which caches them; a transposed conv arrives phase-decomposed,
// its columns (phase, channel) each with its own scale.
//
// Q2 reduces a row's max |act(x)|: a grid-stride pass with 16-byte loads,
// a block reduction, then one atomicMax per block on the float's bit
// pattern (non-negative floats order as their bits do). Q1 turns the max
// into the scale in its prologue, so a scale is one division, the same on
// every block.
//
// Q1 is an implicit GEMM: a block owns 128 output frames of one batch row
// and 64 output columns. It quantizes its input frames plus the
// dilation*(k-1) halo into shared memory as int8 (the quantizer fused into
// the load), then for each tap multiplies the tile shifted by tap*dil rows
// with that tap's [64 x Ci] weight tile on mma.sync m16n8k32 s8 x s8 ->
// s32; the next tap's weights load by cp.async while one is multiplied.
// Eight warps, each 32 rows x 32 columns. Rows of both tiles are padded by
// 16 bytes, so the fragment loads of a warp hit 32 distinct banks.
//
// Bound, one 10 s request at 48 kHz (configs/48k_base.json): the MRF is
// 126 C^2 T multiply-adds a stage, about 372 G over the four stages, plus
// about 10.6 G for conv_pre, the upsamplers and conv_post: 0.39 ms at the
// int8 rate of 1,979 TOP/s. Each launch reads its input and writes its
// output once (3.8 to 30.7 MB a stage's activation in bf16, twice that in
// fp32), and Q2 reads the input once more, so a conv a launch is bound by
// bytes, not operations. Fusing the residual add and the next conv's row
// maximum into the epilogue, and wgmma, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64;         // output frames and columns a block
constexpr int WARPS_M = 4, WARPS_N = 2;  // each warp 32 frames x 32 columns
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MAX_CI = 512, MAX_CO = 4096, MAX_HALO = 64;
constexpr int MAX_SMEM = 232448;
constexpr int ROW_PAD = 16;  // bytes after each shared-memory row
constexpr int ABSMAX_THREADS = 256;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int row_bytes(int ci_pad) { return ci_pad + ROW_PAD; }

// Dynamic shared memory of a launch; false where Q1 does not take the size.
// ops/int8_conv.py:plan mirrors this.
bool plan(int Ci, int Co, int K, int dil, int* smem) {
  if (Ci < 1 || Ci > MAX_CI || Co < 1 || Co > MAX_CO || K < 1 || dil < 1 ||
      (K - 1) * dil > MAX_HALO)
    return false;
  const int rb = row_bytes(round_up(Ci, 32));
  const long long bytes = (long long)(BM + (K - 1) * dil) * rb + 2LL * BN * rb;
  if (bytes > MAX_SMEM) return false;
  *smem = (int)bytes;
  return true;
}

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

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The activation in the input's type, returned as float: torch's leaky_relu
// (x > 0 ? x : x * slope, the product in float32, rounded once to bf16).
__device__ __forceinline__ float act(float v, float slope, bool has_slope) {
  return has_slope && !(v > 0.f) ? __fmul_rn(v, slope) : v;
}
__device__ __forceinline__ float act(__nv_bfloat16 v, float slope, bool has_slope) {
  const float f = __bfloat162float(v);
  return has_slope && !(f > 0.f) ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(f, slope)))
                                 : f;
}

__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-12f), 127.f);
}

// rint(v / scale) clipped to +-127: round half to even, as jnp.round.
__device__ __forceinline__ uint32_t quant(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, __nv_bfloat16* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  v[0] = h[0], v[1] = h[1], v[2] = h[2], v[3] = h[3];
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale, const float* __restrict__ bias,
                     const unsigned* __restrict__ amax, T* __restrict__ y, int Tlen, int Ci,
                     int ci_pad, int Co, int co_pad, int K, int dil, int pad_lo, int Tout,
                     float slope, int has_slope, int vec) {
  extern __shared__ __align__(16) int8_t smem[];
  const int rb = row_bytes(ci_pad);
  const int span = BM + (K - 1) * dil;
  int8_t* xs = smem;             // [span][rb]: the quantized input tile
  int8_t* wring = smem + span * rb;  // 2 x [BN][rb]: one tap's weights, double buffered
  const int n_blk = blockIdx.x * BN, t0 = blockIdx.y * BM, b = blockIdx.z;
  const int tid = threadIdx.x;

  const int chunks = ci_pad / 16;
  auto load_w = [&](int buf, int tap) {
    const int8_t* src = w + ((size_t)tap * co_pad + n_blk) * ci_pad;
    int8_t* dst = wring + buf * BN * rb;
    for (int i = tid; i < BN * chunks; i += THREADS) {
      const int r = i / chunks, c = (i - r * chunks) * 16;
      cp_async16(dst + r * rb + c, src + (size_t)r * ci_pad + c);
    }
    cp_commit();
  };
  load_w(0, 0);

  // quantize the tile's input frames, halo included; 4 channels a thread
  const float a_scale = scale_of(amax[b]);
  const bool slope_on = has_slope != 0;
  const T* xb = x + (size_t)b * Tlen * Ci;
  const int groups = ci_pad / 4;
  for (int i = tid; i < span * groups; i += THREADS) {
    const int r = i / groups, c = (i - r * groups) * 4;
    const int t = t0 - pad_lo + r;
    uint32_t packed = 0;
    if (t >= 0 && t < Tlen && c < Ci) {
      const T* src = xb + (size_t)t * Ci + c;
      T v[4];
      if (vec) {
        load4(src, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = c + e < Ci ? src[e] : T(0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < Ci) packed |= quant(act(v[e], slope, slope_on), a_scale) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(xs + r * rb + c) = packed;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r_w = (warp % WARPS_M) * 32, c_w = (warp / WARPS_M) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int tap = 0; tap < K; ++tap) {
    if (tap + 1 < K) {
      load_w((tap + 1) & 1, tap + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int8_t* wt = wring + (tap & 1) * BN * rb;
    const int8_t* xa = xs + (r_w + g + tap * dil) * rb + q * 4;
    const int8_t* wb = wt + (c_w + g) * rb + q * 4;
    for (int k0 = 0; k0 < ci_pad; k0 += 32) {
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = xa + mi * 16 * rb + k0;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * rb);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * rb + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = wb + ni * 8 * rb + k0;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni]);
    }
    __syncthreads();
  }

  // dequantize: float(acc) * (a_scale * w_scale[o]) + bias[o], rounded once
  T* yb = y + (size_t)b * Tout * Co;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r_w + mi * 16 + g + 8 * h;
      if (t >= Tout) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n_blk + c_w + ni * 8 + q * 2 + e;
          if (o >= Co) continue;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]),
                              __fmul_rn(a_scale, w_scale[o]));
          if (bias != nullptr) v = __fadd_rn(v, bias[o]);
          store(yb + (size_t)t * Co + o, v);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(ABSMAX_THREADS)
    row_absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, long long n,
                      float slope, int has_slope, int vec) {
  const T* row = x + (size_t)blockIdx.y * n;
  const bool slope_on = has_slope != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.f;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (long long i = i0; i < n / V; i += stride) {
      const uint4 u = rv[i];
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(act(v[e], slope, slope_on)));
    }
  } else {
    for (long long i = i0; i < n; i += stride) m = fmaxf(m, fabsf(act(row[i], slope, slope_on)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[ABSMAX_THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < ABSMAX_THREADS / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
  }
}

template <typename T>
cudaError_t launch_conv(const void* x, const void* w, const float* w_scale, const float* bias,
                        const unsigned* amax, void* y, int B, int Tlen, int Ci, int Co, int K,
                        int dil, int pad_lo, int Tout, float slope, int has_slope,
                        cudaStream_t stream) {
  int smem;
  if (!plan(Ci, Co, K, dil, &smem) || B < 1 || B > 65535 || Tlen < 1 || Tout < 1 ||
      pad_lo < 0 || pad_lo > (K - 1) * dil || (Tout + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const int ci_pad = round_up(Ci, 32), co_pad = round_up(Co, BN);
  const int vec = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(co_pad / BN, (Tout + BM - 1) / BM, B);
  int8_conv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), w_scale, bias, amax,
      static_cast<T*>(y), Tlen, Ci, ci_pad, Co, co_pad, K, dil, pad_lo, Tout, slope, has_slope,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_absmax(const void* x, unsigned* amax, int B, long long n, float slope,
                          int has_slope, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n < 1) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const int vec = n % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long per_block = (long long)ABSMAX_THREADS * V * 4;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = B >= 528 ? 1 : 528 / B;  // about 4 blocks an SM in all
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, B);
  row_absmax_kernel<T><<<grid, ABSMAX_THREADS, 0, stream>>>(static_cast<const T*>(x), amax, n,
                                                            slope, has_slope, vec);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared-memory bytes of a Q1 launch for (Ci, Co, K, dil) in *smem;
// returns 0, or cudaErrorInvalidValue where Q1 does not take the size.
extern "C" int int8_conv_plan(int Ci, int Co, int K, int dil, int* smem) {
  return plan(Ci, Co, K, dil, smem) ? 0 : (int)cudaErrorInvalidValue;
}

// Q1 (bound with ctypes). Device pointers:
//   x: [B, T, Ci] float32 (bf16 == 0) or bfloat16 (bf16 == 1), contiguous
//   w: int8 [K, round_up(Co, 64), round_up(Ci, 32)] codes as (tap, out, in),
//      zero where padded, 16-byte aligned
//   w_scale: float32 [Co]; bias: float32 [Co] or null
//   amax: the rows' max |act(x)| as float32 bits [B], from row_absmax
//   y: [B, Tout, Co], x's type
// Output frame t reads input frames t - pad_lo + j*dil, j < K. The
// activation is leaky_relu(slope) where has_slope, else none. Returns the
// cudaError_t of the launch.
extern "C" int int8_conv1d(const void* x, const void* w, const float* w_scale, const float* bias,
                           const unsigned* amax, void* y, int B, int T, int Ci, int Co, int K,
                           int dil, int pad_lo, int Tout, float slope, int has_slope, int bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_conv<__nv_bfloat16>(x, w, w_scale, bias, amax, y, B, T, Ci, Co, K, dil,
                                           pad_lo, Tout, slope, has_slope, s);
  return (int)launch_conv<float>(x, w, w_scale, bias, amax, y, B, T, Ci, Co, K, dil, pad_lo,
                                 Tout, slope, has_slope, s);
}

// Q2 (bound with ctypes): amax[b] = max(amax[b], max |act(x[b])|) over the
// row's n values, as float32 bits; the caller zeroes amax first. x: [B, n]
// float32 or bfloat16, contiguous. Returns the cudaError_t of the launch.
extern "C" int row_absmax(const void* x, unsigned* amax, int B, long long n, float slope,
                          int has_slope, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)launch_absmax<__nv_bfloat16>(x, amax, B, n, slope, has_slope, s);
  return (int)launch_absmax<float>(x, amax, B, n, slope, has_slope, s);
}
