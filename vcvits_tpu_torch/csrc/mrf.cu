// One convolution of a HiFi-GAN MRF stage, with the MRF's prologue and
// epilogues fused in, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/mrf_pallas.py:_mrf_kernel
// (pallas_call in mrf_fused, mrf_pallas.py:134). A stage's MRF is, for each
// ResBlock1 block (kernel k) and each of its dilations d:
//   u = lrelu(conv_{k,d}(lrelu(h)) + b1)            rows outside [0,T) are 0
//   h = h + conv_{k,1}(u) + b2
// and the stage's output is the mean of the blocks' final h. The wrapper in
// ops/mrf.py runs that as 2 launches per (block, dilation) of this kernel:
//   EPI_LRELU  out = lrelu(acc + bias)                     (the first conv)
//   EPI_RES    out = res + acc + bias                      (the second conv)
//   EPI_ADD    out = out + res + acc + bias                (last dilation of a block)
//   EPI_MEAN   out = (out + res + acc + bias) * inv_n      (last dilation, last block)
// with `pre_lrelu` applying lrelu(0.1) to the input as it is staged. Conv
// inputs are rounded to the weights' type (fp32 or bf16) as the Pallas kernel
// does (`.astype(wdt)`), and every sum is taken in fp32; activations between
// launches are fp32.
//
// Bound: 126*C^2 multiply-adds per sample per stage (369 GMAC for 10 s of
// 48 kHz audio), about 0.1 GB of activations per stage, so arithmetic bounds
// it: >= 11 ms at the fp32 CUDA-core rate, >= 0.75 ms at the bf16 tensor-core
// rate. One stage's weights (126*C^2 values, 33 MB fp32 at C=256) do not fit
// in shared memory, so this design keeps the ACTIVATION tile on chip and
// streams weights through L2: a block owns BM time rows x BN output channels
// of one batch row, stages its BM + (k-1)*d input rows (the halo, zeros
// outside [0,T) = "same" padding) 16 input channels at a time, and every
// thread accumulates an 8x4 register tile over all k taps of that slice.
// This is a CUDA-core kernel (fp32 FMA for both weight types); tensor-core
// (wgmma) staging is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;        // input channels staged per step
constexpr int TM = 8;         // rows per thread
constexpr int TN = 4;         // output channels per thread
constexpr int NTHREADS = 256;
constexpr int AS = BK + 1;    // padded row stride of the staged input tile

enum Epilogue { EPI_LRELU = 0, EPI_RES = 1, EPI_ADD = 2, EPI_MEAN = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename WT>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__host__ __device__ constexpr int block_rows(int bn) { return (NTHREADS / (bn / TN)) * TM; }

__host__ __device__ inline int a_floats(int span) { return (span * AS + 3) & ~3; }

template <typename WT, int BN, int EPI>
__global__ void __launch_bounds__(NTHREADS)
mrf_conv_kernel(const float* __restrict__ in, const WT* __restrict__ w,
                const WT* __restrict__ bias, const float* res, float* out, int T, int C,
                int K, int dil, int pre_lrelu, float inv_n) {
  constexpr int TX = BN / TN;
  constexpr int BM = block_rows(BN);
  extern __shared__ float smem[];
  const int span = BM + (K - 1) * dil;
  float* As = smem;                   // [span][AS]   staged input rows
  float* Ws = smem + a_floats(span);  // [K][BK][BN]  weight slice, 16-byte aligned

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int pad = (K - 1) / 2 * dil;
  const float* inb = in + (size_t)b * T * C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) acc[i][jn] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += BK) {
    for (int idx = threadIdx.x; idx < span * BK; idx += NTHREADS) {
      const int r = idx / BK, kk = idx - r * BK, t = t0 - pad + r;
      float v = 0.f;
      if (t >= 0 && t < T) {
        v = inb[(size_t)t * C + ci0 + kk];
        if (pre_lrelu) v = lrelu(v);
        v = round_to<WT>(v);
      }
      As[r * AS + kk] = v;
    }
    for (int idx = threadIdx.x; idx < K * BK * BN; idx += NTHREADS) {
      const int n = idx % BN, rest = idx / BN, kk = rest % BK, m = rest / BK;
      Ws[idx] = to_float(w[((size_t)m * C + ci0 + kk) * C + co0 + n]);
    }
    __syncthreads();
    for (int m = 0; m < K; ++m) {
      const float* Am = As + (ty * TM + m * dil) * AS;
      const float* Wm = Ws + m * BK * BN + tx * TN;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 w4 = *reinterpret_cast<const float4*>(Wm + kk * BN);
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Am[i * AS + kk];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i], w4.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], w4.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], w4.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], w4.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  const int co = co0 + tx * TN;
  float bv[TN];
#pragma unroll
  for (int jn = 0; jn < TN; ++jn) bv[jn] = to_float(bias[co + jn]);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) break;
    const size_t o = ((size_t)b * T + t) * C + co;
    float4 v = make_float4(acc[i][0] + bv[0], acc[i][1] + bv[1], acc[i][2] + bv[2],
                           acc[i][3] + bv[3]);
    if (EPI == EPI_LRELU) {
      v = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
    } else {
      const float4 r4 = *reinterpret_cast<const float4*>(res + o);
      v = make_float4(v.x + r4.x, v.y + r4.y, v.z + r4.z, v.w + r4.w);
      if (EPI == EPI_ADD || EPI == EPI_MEAN) {
        const float4 o4 = *reinterpret_cast<const float4*>(out + o);
        v = make_float4(v.x + o4.x, v.y + o4.y, v.z + o4.z, v.w + o4.w);
      }
      if (EPI == EPI_MEAN) v = make_float4(v.x * inv_n, v.y * inv_n, v.z * inv_n, v.w * inv_n);
    }
    *reinterpret_cast<float4*>(out + o) = v;
  }
}

template <typename WT, int BN, int EPI>
cudaError_t launch(const float* in, const WT* w, const WT* bias, const float* res, float* out,
                   int B, int T, int C, int K, int dil, int pre_lrelu, float inv_n,
                   cudaStream_t stream) {
  constexpr int BM = block_rows(BN);
  const int span = BM + (K - 1) * dil;
  const size_t smem = (size_t)(a_floats(span) + K * BK * BN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mrf_conv_kernel<WT, BN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BM - 1) / BM, C / BN, B);
  mrf_conv_kernel<WT, BN, EPI><<<grid, NTHREADS, smem, stream>>>(in, w, bias, res, out, T, C,
                                                                   K, dil, pre_lrelu, inv_n);
  return cudaGetLastError();
}

template <typename WT, int BN>
cudaError_t by_epilogue(int epi, const void* in, const void* w, const void* bias,
                        const void* res, void* out, int B, int T, int C, int K, int dil,
                        int pre_lrelu, float inv_n, cudaStream_t s) {
  const float* i = static_cast<const float*>(in);
  const WT* wt = static_cast<const WT*>(w);
  const WT* bt = static_cast<const WT*>(bias);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  switch (epi) {
    case EPI_LRELU: return launch<WT, BN, EPI_LRELU>(i, wt, bt, r, o, B, T, C, K, dil, pre_lrelu, inv_n, s);
    case EPI_RES: return launch<WT, BN, EPI_RES>(i, wt, bt, r, o, B, T, C, K, dil, pre_lrelu, inv_n, s);
    case EPI_ADD: return launch<WT, BN, EPI_ADD>(i, wt, bt, r, o, B, T, C, K, dil, pre_lrelu, inv_n, s);
    case EPI_MEAN: return launch<WT, BN, EPI_MEAN>(i, wt, bt, r, o, B, T, C, K, dil, pre_lrelu, inv_n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers, all contiguous:
//   in, res, out: float32 [B, T, C] (res may alias out; unused for EPI_LRELU)
//   w: [K, C, C] as (tap, in channel, out channel), bias: [C], both float32
//   (bf16 == 0) or bfloat16 (bf16 == 1).
// C must be a multiple of 32. Returns the cudaError_t of the launch.
extern "C" int mrf_conv(const void* in, const void* w, const void* bias, const void* res,
                        void* out, int B, int T, int C, int K, int dil, int pre_lrelu, int epi,
                        float inv_n, int bf16, void* stream) {
  if (C % 32 != 0 || K < 1 || dil < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = C % 64 == 0;
  if (bf16) {
    return (int)(wide ? by_epilogue<__nv_bfloat16, 64>(epi, in, w, bias, res, out, B, T, C, K,
                                                       dil, pre_lrelu, inv_n, s)
                      : by_epilogue<__nv_bfloat16, 32>(epi, in, w, bias, res, out, B, T, C, K,
                                                       dil, pre_lrelu, inv_n, s));
  }
  return (int)(wide ? by_epilogue<float, 64>(epi, in, w, bias, res, out, B, T, C, K, dil,
                                             pre_lrelu, inv_n, s)
                    : by_epilogue<float, 32>(epi, in, w, bias, res, out, B, T, C, K, dil,
                                             pre_lrelu, inv_n, s));
}
