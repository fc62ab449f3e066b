// STFT magnitude and log-mel of a batch of waveforms in one pass, for Hopper
// (sm_90a): kernels K3 and K4.
//
// K3 replaces the Pallas TPU kernel vcvits_tpu/ops/stft_pallas.py:
// spectrogram_mel_fused (pallas_call at stft_pallas.py:196); K4 replaces
// mel_spectrogram_fused in the same file (pallas_call at :107). For each
// row b of y [B, T] and each frame f of the (n_fft - hop)/2 reflect-padded
// signal, at hop stride, center=False, with w the periodic Hann window of
// win_length zero-padded to n_fft:
//   X[k] = sum_n x[f*hop + n] w[n] exp(-2 pi i n k / n_fft)        k < F = n_fft/2 + 1
//   spec[b, f, k] = sqrt(re(X[k])^2 + im(X[k])^2 + 1e-6)
//   mel[b, f, m]  = log(max(sum_k spec[b, f, k] * fbank[m, k], clip))
// from fp32 samples to fp32 outputs, with the arithmetic in between in
// float64: in fp32 an FFT's rounding, about eps x the frame's norm in every
// bin, puts the log-mel of a band far below its frame's peak (a speech
// frame's lowest band, 1e-5 of the peak bin) 1e-4 or more off, and fp32
// FFTs of other libraries do no better there. Three instances of one kernel: spec + mel (K3, the train step's
// frozen targets), spec only (K3, voice_conversion's posterior input) and
// mel only (K4, the trainer's validation mel and the MCD metric's MFCC),
// which writes no spectrogram.
//
// Bound, on the work the function needs: per frame a real FFT (about
// 2.5*n_fft*log2(n_fft) = 56 kFLOP at n_fft 2048), the window and the
// magnitude, and for the mel a sum over each filter's non-zero band (2014
// of the 128 x 1025 fbank entries at 48 kHz), against 2 KB of new input,
// 4 KB of spec and 0.5 KB of mel output per frame. At 3.35 TB/s and the
// 67 TFLOP/s fp32 CUDA-core rate (the function's own type; the float64 the
// kernel computes in runs at half that rate) that is >= 0.012 ms for the 16 x 4 s train
// targets (bytes: y, the 24.6 MB spec, the mel), >= 0.0017 ms for one 10 s
// spec (bytes) and >= 0.0009 ms for K4 on one 10 s clip (operations).
// The spec store and the shared-memory passes of the FFT are what this
// kernel is held by; there is no matrix product left for tensor cores
// (fp32 parity would need 3xTF32, and the band-limited mel is 4 kFLOP a
// frame).
//
// Design: a real FFT through an M = n_fft/2 point complex FFT. A block owns
// FT consecutive frames of one row. It stages the (FT-1)*hop + n_fft samples
// they span once in shared memory, reflecting at both ends as it reads, so
// the overlapped [FT, n_fft] frame copy never exists in device memory. Each
// frame, packed as z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1], is transformed by
// a Stockham FFT in shared memory: radix-4 stages (one radix-2 stage where
// log2(M) is odd), each thread loading its butterfly's points into
// registers, applying the twiddles, and storing to the other of two buffers
// (re and im in separate float64 arrays, one double of padding every 16, so
// that the strided loads and the first stage's stride-4 stores of a half
// warp hit distinct banks).
// The first stage packs and windows its points as it loads them from the
// staged samples, so z is never stored. The split step recovers the F bins:
//   X[k] = (Z[k] + Z*[M-k])/2 - i W^k (Z[k] - Z*[M-k])/2,  W = exp(-2 pi i / n_fft).
// Magnitudes go to `spec` (one contiguous run of FT*F floats per block,
// coalesced; not in the mel-only instance) and, for the mel, to shared
// memory, where one thread per (frame, mel) sums the filter's band in
// ascending bins (the dense product's order, without its zeros) and takes
// the log. The window and the twiddles are float64 tables (ops/stft_mel.py:
// _window, fft_twiddles): W^k for the split step, then each stage's factors laid out
// so that neighbouring threads read neighbouring entries; it is read
// through the read-only cache, where one copy per SM serves every block
// (a single W^k table read at the stages' strides would put up to 16
// threads of a warp on one bank). A ragged last frame tile writes only its
// valid frames.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_MELS = 256;

enum Mode { SPEC_MEL = 0, SPEC_ONLY = 1, MEL_ONLY = 2 };

// index of complex point a in a padded re or im array
__device__ __forceinline__ int padded(int a) { return a + (a >> 4); }

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <int R>
__device__ __forceinline__ void dft(double2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(double2 (&v)[2]) {
  const double2 a = v[0], b = v[1];
  v[0] = make_double2(a.x + b.x, a.y + b.y);
  v[1] = make_double2(a.x - b.x, a.y - b.y);
}

template <>
__device__ __forceinline__ void dft<4>(double2 (&v)[4]) {
  const double2 t0 = make_double2(v[0].x + v[2].x, v[0].y + v[2].y);
  const double2 t1 = make_double2(v[0].x - v[2].x, v[0].y - v[2].y);
  const double2 t2 = make_double2(v[1].x + v[3].x, v[1].y + v[3].y);
  const double2 t3 = make_double2(v[1].y - v[3].y, v[3].x - v[1].x);  // -i (v1 - v3)
  v[0] = make_double2(t0.x + t2.x, t0.y + t2.y);
  v[2] = make_double2(t0.x - t2.x, t0.y - t2.y);
  v[1] = make_double2(t1.x + t3.x, t1.y + t3.y);
  v[3] = make_double2(t1.x - t3.x, t1.y - t3.y);
}

// One Stockham stage of radix R over the FT frames of src into dst: p points
// already combined, per = M / R butterflies a frame. Butterfly i of a frame
// reads points i + r*per, multiplies point r by exp(-2 pi i r k / (p R)),
// k = i mod p (tw[(r-1)*p + k]), and writes its outputs to (i-k)*R + k + r*p.
// A frame's re lies at f*fs, its im at f*fs + ld.
template <int R>
__device__ __forceinline__ void fft_stage(const double* __restrict__ src,
                                          double* __restrict__ dst,
                                          const double2* __restrict__ tw, int p, int log_per,
                                          int units, int fs, int ld) {
  const int per = 1 << log_per;
  for (int u = threadIdx.x; u < units; u += NTHREADS) {
    const int f = u >> log_per, i = u & (per - 1);
    const int k = i & (p - 1);
    const double* s = src + f * fs;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = padded(i + r * per);
      v[r] = make_double2(s[a], s[ld + a]);
    }
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + (r - 1) * p + k));
    dft<R>(v);
    double* d = dst + f * fs;
    const int j = (i - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = padded(j + r * p);
      d[a] = v[r].x;
      d[ld + a] = v[r].y;
    }
  }
}

// The first radix-4 stage (p = 1, no twiddles), reading its points straight
// from the staged samples: point n of frame f is packed and windowed as it
// is loaded, z[n] = x[f*hop + 2n] w[2n] + i x[f*hop + 2n+1] w[2n+1].
__device__ __forceinline__ void first_stage(const float* __restrict__ sig,
                                            const double2* __restrict__ window,
                                            double* __restrict__ dst, int hop, int log_per,
                                            int units, int fs, int ld) {
  const int per = 1 << log_per;
  for (int u = threadIdx.x; u < units; u += NTHREADS) {
    const int f = u >> log_per, i = u & (per - 1);
    const float* x = sig + f * hop;
    double2 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = i + r * per;
      const float2 s = *reinterpret_cast<const float2*>(x + 2 * n);
      const double2 w = __ldg(window + n);
      v[r] = make_double2(s.x * w.x, s.y * w.y);
    }
    dft<4>(v);
    double* d = dst + f * fs;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = padded(4 * i + r);
      d[a] = v[r].x;
      d[ld + a] = v[r].y;
    }
  }
}

template <int FT, int MODE>
__global__ void __launch_bounds__(NTHREADS)
stft_mel_kernel(const float* __restrict__ y, const double* __restrict__ window,
                const double2* __restrict__ twiddle, const int* __restrict__ bands,
                const float* __restrict__ weights, float* __restrict__ spec,
                float* __restrict__ mel, int T, int NF, int log_m, int hop, int n_mels,
                double clip) {
  constexpr bool kSpec = MODE != MEL_ONLY;
  constexpr bool kMel = MODE != SPEC_ONLY;
  extern __shared__ double2 smem2[];
  __shared__ int band[3 * MAX_MELS];  // first bin, length, weight offset of each mel
  const int M = 1 << log_m, n_fft = 2 * M, F = M + 1;
  const int ld = M + (M >> 4), fs = 2 * ld;
  double* buf_a = reinterpret_cast<double*>(smem2);  // [FT][re, im][ld]
  double* buf_b = buf_a + FT * fs;  // the same; the staged fp32 samples first
  float* staged = reinterpret_cast<float*>(buf_b);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int valid = min(FT, NF - f0);

  // stage the reflect-padded samples of frames f0 .. f0+FT-1
  {
    const float* row = y + (size_t)b * T;
    const int pad = (n_fft - hop) / 2;
    const int padded_len = T + 2 * pad;
    const int span = (FT - 1) * hop + n_fft;
    for (int j = tid; j < span; j += NTHREADS) {
      const int p = f0 * hop + j;
      float v = 0.f;
      if (p < padded_len) {
        int i = p - pad;
        if (i < 0) i = -i;
        if (i >= T) i = 2 * (T - 1) - i;
        v = row[i];
      }
      staged[j] = v;
    }
  }
  if (kMel) {
    for (int o = tid; o < 3 * n_mels; o += NTHREADS) band[o] = bands[o];
  }
  __syncthreads();

  // the M-point complex FFT: the first stage from the samples into buf_a,
  // then back and forth (the table's first stage entries, p = 1, are ones)
  first_stage(staged, reinterpret_cast<const double2*>(window), buf_a, hop, log_m - 2,
              FT << (log_m - 2), fs, ld);
  __syncthreads();
  double* src = buf_a;
  double* dst = buf_b;
  const double2* tw = twiddle + M + 3;
  int p = 4, lm = log_m - 2;
  for (; lm >= 2; lm -= 2) {
    fft_stage<4>(src, dst, tw, p, log_m - 2, FT << (log_m - 2), fs, ld);
    __syncthreads();
    tw += 3 * p;
    p *= 4;
    double* t = src;
    src = dst;
    dst = t;
  }
  if (lm == 1) {
    fft_stage<2>(src, dst, tw, p, log_m - 1, FT << (log_m - 1), fs, ld);
    __syncthreads();
    double* t = src;
    src = dst;
    dst = t;
  }

  // split step, magnitude; the block's spec rows are one contiguous run.
  // Bin k < M per thread; the thread of bin 0 also writes bin M, X[M] =
  // re Z[0] - im Z[0] (the general formula at k = M, with W^M = -1).
  double* mags = dst;  // [FT][F], mel only
  float* spec_out = kSpec ? spec + ((size_t)b * NF + f0) * F : nullptr;
  for (int u = tid; u < (FT << log_m); u += NTHREADS) {
    const int f = u >> log_m, k = u & (M - 1);
    const double* z = src + f * fs;
    const int a = padded(k), c = padded((M - k) & (M - 1));
    const double2 zk = make_double2(z[a], z[ld + a]);
    const double2 zc = make_double2(z[c], -z[ld + c]);  // conj(Z[M-k])
    const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y + zc.y));
    const double2 d = make_double2(0.5 * (zk.x - zc.x), 0.5 * (zk.y - zc.y));
    const double2 wd = cmul(__ldg(twiddle + k), d);
    const double re = e.x + wd.y, im = e.y - wd.x;  // e - i (W d)
    const double mag = sqrt(re * re + im * im + 1e-6);
    const int o = f * F + k;
    if (kSpec && f < valid) spec_out[o] = __double2float_rn(mag);
    if (kMel) mags[o] = mag;
    if (k == 0) {
      const double nyq = zk.x - zk.y;
      const double mag_m = sqrt(nyq * nyq + 1e-6);
      if (kSpec && f < valid) spec_out[o + M] = __double2float_rn(mag_m);
      if (kMel) mags[o + M] = mag_m;
    }
  }

  if (kMel) {
    __syncthreads();
    float* mel_out = mel + ((size_t)b * NF + f0) * n_mels;
    for (int u = tid; u < FT * n_mels; u += NTHREADS) {
      const int f = u / n_mels, m = u - f * n_mels;
      const double* s = mags + f * F + band[m];
      const float* wt = weights + band[2 * n_mels + m];
      const int len = band[n_mels + m];
      double acc = 0.0;
#pragma unroll 4
      for (int j = 0; j < len; ++j) acc = fma(s[j], (double)__ldg(wt + j), acc);
      if (f < valid) mel_out[u] = __double2float_rn(log(fmax(acc, clip)));
    }
  }
}

size_t smem_bytes(int ft, int m) { return (size_t)2 * ft * 2 * (m + (m >> 4)) * sizeof(double); }

template <int FT, int MODE>
cudaError_t launch(const float* y, const double* window, const double2* twiddle,
                   const int* bands, const float* weights, float* spec, float* mel, int B,
                   int T, int NF, int log_m, int hop, int n_mels, double clip,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(FT, 1 << log_m);
  cudaError_t err = cudaFuncSetAttribute(stft_mel_kernel<FT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((NF + FT - 1) / FT, B);
  stft_mel_kernel<FT, MODE><<<grid, NTHREADS, smem, stream>>>(
      y, window, twiddle, bands, weights, spec, mel, T, NF, log_m, hop, n_mels, clip);
  return cudaGetLastError();
}

template <int FT>
cudaError_t by_mode(int mode, const float* y, const double* window, const double2* twiddle,
                    const int* bands, const float* weights, float* spec, float* mel, int B,
                    int T, int NF, int log_m, int hop, int n_mels, double clip, cudaStream_t s) {
  switch (mode) {
    case SPEC_MEL: return launch<FT, SPEC_MEL>(y, window, twiddle, bands, weights, spec, mel, B, T, NF, log_m, hop, n_mels, clip, s);
    case SPEC_ONLY: return launch<FT, SPEC_ONLY>(y, window, twiddle, bands, weights, spec, mel, B, T, NF, log_m, hop, n_mels, clip, s);
    case MEL_ONLY: return launch<FT, MEL_ONLY>(y, window, twiddle, bands, weights, spec, mel, B, T, NF, log_m, hop, n_mels, clip, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers, all contiguous:
//   y [B, T] float32; window [n_fft] float64 (Hann, zero-padded to n_fft);
//   twiddle [n_fft, 2] float64 (ops/stft_mel.py:fft_twiddles);
//   bands [3, n_mels] int32 and weights float32 (ops/stft_mel.py:mel_bands;
//   unused with mode 1); spec [B, NF, n_fft/2+1] float32 (unused with
//   mode 2); mel [B, NF, n_mels] float32 (unused with mode 1);
//   NF = 1 + (T + 2*((n_fft-hop)/2) - n_fft) / hop.
// mode: 0 spec + mel, 1 spec only, 2 mel only. ft (frames per block): 1 or
// 2. Needs n_fft a power of two from 64 to 4096, hop a multiple of 4 and
// <= n_fft, T > (n_fft-hop)/2 (one reflection) and, with a mel, 1 <= n_mels
// <= 256. Returns the cudaError_t of the launch.
extern "C" int stft_mel(const void* y, const void* window, const void* twiddle,
                        const void* bands, const void* weights, void* spec, void* mel, int B,
                        int T, int n_fft, int hop, int n_mels, int ft, int mode, double clip,
                        void* stream) {
  if (n_fft < 64 || n_fft > 4096) return (int)cudaErrorInvalidValue;
  int log_m = 0;
  while ((2 << log_m) < n_fft) ++log_m;
  const int pad = (n_fft - hop) / 2;
  if (B < 1 || (2 << log_m) != n_fft || hop < 4 || hop % 4 || hop > n_fft || T <= pad)
    return (int)cudaErrorInvalidValue;
  if (mode != SPEC_ONLY && (n_mels < 1 || n_mels > MAX_MELS)) return (int)cudaErrorInvalidValue;
  const int NF = 1 + (T + 2 * pad - n_fft) / hop;
  if (NF < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yy = static_cast<const float*>(y);
  const double* wn = static_cast<const double*>(window);
  const double2* tw = static_cast<const double2*>(twiddle);
  const int* bd = static_cast<const int*>(bands);
  const float* wt = static_cast<const float*>(weights);
  float* sp = static_cast<float*>(spec);
  float* ml = static_cast<float*>(mel);
  switch (ft) {
    case 1: return (int)by_mode<1>(mode, yy, wn, tw, bd, wt, sp, ml, B, T, NF, log_m, hop, n_mels, clip, s);
    case 2: return (int)by_mode<2>(mode, yy, wn, tw, bd, wt, sp, ml, B, T, NF, log_m, hop, n_mels, clip, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
