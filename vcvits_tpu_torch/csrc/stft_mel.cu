// STFT magnitude and log-mel of a batch of waveforms in one pass, for Hopper
// (sm_90a): kernels K3 and K4.
//
// K3 replaces the Pallas TPU kernel vcvits_tpu/ops/stft_pallas.py:
// spectrogram_mel_fused (pallas_call at stft_pallas.py:196); K4 replaces
// mel_spectrogram_fused in the same file (pallas_call at :107). For each
// row b of y [B, T] and each frame f of the (n_fft - hop)/2 reflect-padded
// signal, at hop stride, center=False:
//   re[k] = sum_n x[f*hop + n] * cos_b[n, k],  im[k] = sum_n x[f*hop + n] * sin_b[n, k]
//   spec[b, f, k] = sqrt(re^2 + im^2 + 1e-6)                     k < n_fft/2 + 1
//   mel[b, f, m]  = log(max(sum_k spec[b, f, k] * fbank[k, m], clip))
// with the Hann window folded into the fp32 bases (built in float64 by the
// wrapper, as _dft_basis does). Every sum is fp32 FMA. Three instances of
// one kernel: spec + mel (K3, the train step's frozen targets), spec only
// (K3, voice_conversion's posterior input) and mel only (K4, the trainer's
// validation mel and the MCD metric's MFCC), which writes no spectrogram.
//
// Bound, on the work the function needs: per frame a real FFT (about
// 2.5*n_fft*log2(n_fft) = 56 kFLOP at n_fft 2048), the magnitude, and for
// the mel the 2*F*n_mels product (262 kFLOP at F 1025, 128 mels), against
// 2 KB of new input, 4 KB of spec and 0.5 KB of mel output per frame. At
// 3.35 TB/s and the 67 TFLOP/s fp32 CUDA-core rate that is >= 0.029 ms for
// the 16 x 4 s train targets (operations), >= 0.0017 ms for one 10 s spec
// (bytes) and >= 0.0045 ms for K4 on one 10 s clip (937 frames,
// operations). This kernel does a direct DFT instead, 4*n_fft*F = 8.4 MFLOP
// per frame, about 150x the FFT's operations: the simple form that is
// right, not the fast one.
//
// Design: a block owns FT consecutive frames of one row. It stages the
// (FT-1)*hop + n_fft samples those frames span once in shared memory,
// reflecting at both ends as it reads, so the overlapped [FT, n_fft] frame
// copy the TPU kernels build in HBM never exists. Then it walks the bins in
// tiles of NTHREADS: each thread owns one bin and keeps FT (re, im) pairs in
// registers while it streams its column of the bases from L2 (each block
// reads the 16.8 MB of bases once) and reads the samples four at a time as
// broadcast 16-byte loads. The tile's magnitudes are stored to `spec`
// (coalesced over bins; not in the mel-only instance) and, for the mel,
// staged in shared memory, where each thread folds them into its own
// FT*n_mels/NTHREADS mel sums; the log is taken after the last tile, and a
// ragged last frame tile writes only its NF % FT valid frames.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

enum Mode { SPEC_MEL = 0, SPEC_ONLY = 1, MEL_ONLY = 2 };

template <int FT, int MODE>
__global__ void __launch_bounds__(NTHREADS)
stft_mel_kernel(const float* __restrict__ y, const float* __restrict__ cosb,
                const float* __restrict__ sinb, const float* __restrict__ fbank,
                float* __restrict__ spec, float* __restrict__ mel, int T, int NF, int n_fft,
                int hop, int n_mels, float clip) {
  constexpr bool kSpec = MODE != MEL_ONLY;
  constexpr bool kMel = MODE != SPEC_ONLY;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int F = n_fft / 2 + 1;
  const int pad = (n_fft - hop) / 2;
  const int span = (FT - 1) * hop + n_fft;
  float* sig = smem;                                  // [span]
  float* tile = sig + ((span + 3) & ~3);              // [FT][NTHREADS], mel only
  float* melacc = tile + FT * NTHREADS;               // [FT * n_mels], mel only

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* row = y + (size_t)b * T;
  const int padded_len = T + 2 * pad;

  // stage the reflect-padded samples of frames f0 .. f0+FT-1
  for (int j = tid; j < span; j += NTHREADS) {
    const int p = f0 * hop + j;
    float v = 0.f;
    if (p < padded_len) {
      int i = p - pad;
      if (i < 0) i = -i;
      if (i >= T) i = 2 * (T - 1) - i;
      v = row[i];
    }
    sig[j] = v;
  }
  if (kMel) {
    for (int o = tid; o < FT * n_mels; o += NTHREADS) melacc[o] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < F; k0 += NTHREADS) {
    const int k = k0 + tid;
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    if (k < F) {
      for (int n = 0; n < n_fft; n += 4) {
        const float c0 = __ldg(cosb + (size_t)n * F + k);
        const float c1 = __ldg(cosb + (size_t)(n + 1) * F + k);
        const float c2 = __ldg(cosb + (size_t)(n + 2) * F + k);
        const float c3 = __ldg(cosb + (size_t)(n + 3) * F + k);
        const float s0 = __ldg(sinb + (size_t)n * F + k);
        const float s1 = __ldg(sinb + (size_t)(n + 1) * F + k);
        const float s2 = __ldg(sinb + (size_t)(n + 2) * F + k);
        const float s3 = __ldg(sinb + (size_t)(n + 3) * F + k);
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(sig + f * hop + n);
          re[f] = fmaf(x.x, c0, re[f]);
          im[f] = fmaf(x.x, s0, im[f]);
          re[f] = fmaf(x.y, c1, re[f]);
          im[f] = fmaf(x.y, s1, im[f]);
          re[f] = fmaf(x.z, c2, re[f]);
          im[f] = fmaf(x.z, s2, im[f]);
          re[f] = fmaf(x.w, c3, re[f]);
          im[f] = fmaf(x.w, s3, im[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float mag = k < F ? sqrtf(re[f] * re[f] + im[f] * im[f] + 1e-6f) : 0.f;
      if (kSpec && k < F && f0 + f < NF) spec[((size_t)b * NF + f0 + f) * F + k] = mag;
      if (kMel) tile[f * NTHREADS + tid] = mag;
    }
    if (kMel) {
      __syncthreads();
      const int nk = min(NTHREADS, F - k0);
      for (int o = tid; o < FT * n_mels; o += NTHREADS) {
        const int f = o / n_mels, m = o - f * n_mels;
        const float* t = tile + f * NTHREADS;
        const float* fb = fbank + (size_t)k0 * n_mels + m;
        float acc = 0.f;
        for (int kk = 0; kk < nk; ++kk) acc = fmaf(t[kk], __ldg(fb + (size_t)kk * n_mels), acc);
        melacc[o] += acc;
      }
      __syncthreads();
    }
  }

  if (kMel) {
    for (int o = tid; o < FT * n_mels; o += NTHREADS) {
      const int f = o / n_mels;
      if (f0 + f < NF) mel[((size_t)b * NF + f0) * n_mels + o] = logf(fmaxf(melacc[o], clip));
    }
  }
}

size_t smem_bytes(int ft, int mode, int n_fft, int hop, int n_mels) {
  const int span = (ft - 1) * hop + n_fft;
  size_t floats = (span + 3) & ~3;
  if (mode != SPEC_ONLY) floats += (size_t)ft * NTHREADS + (size_t)ft * n_mels;
  return floats * sizeof(float);
}

template <int FT, int MODE>
cudaError_t launch(const float* y, const float* cosb, const float* sinb, const float* fbank,
                   float* spec, float* mel, int B, int T, int NF, int n_fft, int hop,
                   int n_mels, float clip, cudaStream_t stream) {
  const size_t smem = smem_bytes(FT, MODE, n_fft, hop, n_mels);
  cudaError_t err = cudaFuncSetAttribute(stft_mel_kernel<FT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((NF + FT - 1) / FT, B);
  stft_mel_kernel<FT, MODE><<<grid, NTHREADS, smem, stream>>>(y, cosb, sinb, fbank, spec, mel,
                                                              T, NF, n_fft, hop, n_mels, clip);
  return cudaGetLastError();
}

template <int FT>
cudaError_t by_mode(int mode, const float* y, const float* cosb, const float* sinb,
                    const float* fbank, float* spec, float* mel, int B, int T, int NF, int n_fft,
                    int hop, int n_mels, float clip, cudaStream_t s) {
  switch (mode) {
    case SPEC_MEL: return launch<FT, SPEC_MEL>(y, cosb, sinb, fbank, spec, mel, B, T, NF, n_fft, hop, n_mels, clip, s);
    case SPEC_ONLY: return launch<FT, SPEC_ONLY>(y, cosb, sinb, fbank, spec, mel, B, T, NF, n_fft, hop, n_mels, clip, s);
    case MEL_ONLY: return launch<FT, MEL_ONLY>(y, cosb, sinb, fbank, spec, mel, B, T, NF, n_fft, hop, n_mels, clip, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers, all contiguous
// float32:
//   y [B, T]; cosb, sinb [n_fft, n_fft/2+1]; fbank [n_fft/2+1, n_mels]
//   spec [B, NF, n_fft/2+1] (unused with mode 2), mel [B, NF, n_mels]
//   (unused with mode 1), NF = 1 + (T + 2*((n_fft-hop)/2) - n_fft) / hop.
// mode: 0 spec + mel, 1 spec only, 2 mel only. ft (frames per block): 8, 16
// or 32. Needs T > (n_fft-hop)/2 (one reflection), hop % 4 == 0 and
// n_fft % 4 == 0. Returns the cudaError_t of the launch.
extern "C" int stft_mel(const void* y, const void* cosb, const void* sinb, const void* fbank,
                        void* spec, void* mel, int B, int T, int n_fft, int hop, int n_mels,
                        int ft, int mode, float clip, void* stream) {
  const int pad = (n_fft - hop) / 2;
  if (B < 1 || hop < 4 || hop % 4 || n_fft % 4 || pad < 0 || T <= pad || n_mels < 1)
    return (int)cudaErrorInvalidValue;
  const int NF = 1 + (T + 2 * pad - n_fft) / hop;
  if (NF < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yy = static_cast<const float*>(y);
  const float* cb = static_cast<const float*>(cosb);
  const float* sb = static_cast<const float*>(sinb);
  const float* fb = static_cast<const float*>(fbank);
  float* sp = static_cast<float*>(spec);
  float* ml = static_cast<float*>(mel);
  switch (ft) {
    case 8: return (int)by_mode<8>(mode, yy, cb, sb, fb, sp, ml, B, T, NF, n_fft, hop, n_mels, clip, s);
    case 16: return (int)by_mode<16>(mode, yy, cb, sb, fb, sp, ml, B, T, NF, n_fft, hop, n_mels, clip, s);
    case 32: return (int)by_mode<32>(mode, yy, cb, sb, fb, sp, ml, B, T, NF, n_fft, hop, n_mels, clip, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
