// The WaveNet gate and its gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/fused_gate.py:
// fused_gate_pallas (pallas_call at fused_gate.py:44). For rows r of
// a [R, 2H] (R = B*T) and the speaker term b, broadcast over time:
//   x = a + b;  out[r, c] = tanh(x[r, c]) * sigmoid(x[r, H + c])      c < H
// and, for the training WN, the backward from grad_out [R, H]:
//   t = tanh(x[:H]), s = sigmoid(x[H:])
//   grad_x[r, c]     = grad_out[r, c] * s * (1 - t^2)
//   grad_x[r, H + c] = grad_out[r, c] * t * s * (1 - s)
// grad_a is grad_x; the wrapper sums grad_x over the broadcast time axis for
// grad_b. The TPU package has no backward kernel: one is needed here because
// the port's WN runs this gate in training, where an output launched through
// ctypes would otherwise cut the autograd graph.
//
// b is absent (a null pointer) or one [2H] row per batch row, broadcast over
// T. Arithmetic is fp32; a, b and the outputs are float32 or bfloat16 (the
// input type).
//
// Bound: bytes. Forward reads 2H and writes H values per row; backward reads
// 3H and writes 2H. At the WN's shapes (a few thousand rows of 256) it moves
// a few MB, so a launch takes microseconds and launch overhead dominates.
// Design: one thread per (row, c < H) pair, so each thread loads both halves
// of its gate pair and neighbouring threads touch neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__device__ __forceinline__ void load_pair(const T* a, const T* b, long long r, int c, int H,
                                          int T_len, float& x1, float& x2) {
  const long long base = r * 2 * H;
  x1 = to_float(a[base + c]);
  x2 = to_float(a[base + H + c]);
  if (b != nullptr) {
    const long long bb = (r / T_len) * 2 * H;
    x1 += to_float(b[bb + c]);
    x2 += to_float(b[bb + H + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gate_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                long long R, int H, int T_len) {
  const long long n = R * H;
  for (long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * NTHREADS) {
    const long long r = i / H;
    const int c = (int)(i - r * H);
    float x1, x2;
    load_pair(a, b, r, c, H, T_len, x1, x2);
    out[i] = from_float<T>(tanhf(x1) * sigmoid(x2));
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gate_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ a,
                const T* __restrict__ b, T* __restrict__ grad_x, long long R, int H,
                int T_len) {
  const long long n = R * H;
  for (long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * NTHREADS) {
    const long long r = i / H;
    const int c = (int)(i - r * H);
    float x1, x2;
    load_pair(a, b, r, c, H, T_len, x1, x2);
    const float t = tanhf(x1), s = sigmoid(x2);
    const float g = to_float(grad_out[i]);
    grad_x[r * 2 * H + c] = from_float<T>(g * s * (1.f - t * t));
    grad_x[r * 2 * H + H + c] = from_float<T>(g * t * s * (1.f - s));
  }
}

int grid_for(long long n) {
  long long blocks = (n + NTHREADS - 1) / NTHREADS;
  return (int)(blocks < 65535 * 16 ? (blocks > 0 ? blocks : 1) : 65535 * 16);
}

template <typename T>
cudaError_t fwd(const void* a, const void* b, void* out, long long R, int H, int T_len,
                cudaStream_t s) {
  gate_fwd_kernel<T><<<grid_for(R * H), NTHREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), R, H, T_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* go, const void* a, const void* b, void* gx, long long R, int H,
                int T_len, cudaStream_t s) {
  gate_bwd_kernel<T><<<grid_for(R * H), NTHREADS, 0, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(gx), R, H, T_len);
  return cudaGetLastError();
}

bool bad_args(long long R, int H, int T_len) { return R < 0 || H < 1 || T_len < 1; }

}  // namespace

// Plain C entry points (bound with ctypes). Device pointers, all contiguous
// and of one type, float32 (bf16 == 0) or bfloat16 (bf16 == 1):
//   a [R, 2H]; b null or [R / T_len, 2H]; out, grad_out [R, H]; grad_x [R, 2H].
// Each returns the cudaError_t of its launch.
extern "C" int fused_gate_fwd(const void* a, const void* b, void* out, long long R, int H,
                              int T_len, int bf16, void* stream) {
  if (bad_args(R, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd<__nv_bfloat16>(a, b, out, R, H, T_len, s)
                    : fwd<float>(a, b, out, R, H, T_len, s));
}

extern "C" int fused_gate_bwd(const void* grad_out, const void* a, const void* b, void* grad_x,
                              long long R, int H, int T_len, int bf16, void* stream) {
  if (bad_args(R, H, T_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd<__nv_bfloat16>(grad_out, a, b, grad_x, R, H, T_len, s)
                    : bwd<float>(grad_out, a, b, grad_x, R, H, T_len, s));
}
