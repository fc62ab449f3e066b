// The WaveNet gate and its gradient, for Hopper (sm_90a): the standalone
// kernel of the training WaveNets.
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/fused_gate.py:
// fused_gate_pallas (pallas_call at fused_gate.py:44). For rows t of batch
// row bi of a [B, T, 2H] and the speaker term b [B, 2H], broadcast over time:
//   x = a + b;  out[bi, t, c] = tanh(x[c]) * sigmoid(x[H + c])      c < H
// and, for the training WN, the backward from grad_out [B, T, H]:
//   th = tanh(x[:H]), s = sigmoid(x[H:])
//   grad_x[c]     = grad_out[c] * s * (1 - th^2)
//   grad_x[H + c] = grad_out[c] * th * s * (1 - s)
// grad_a is grad_x; the wrapper sums grad_x over the broadcast time axis for
// grad_b. The TPU package has no backward kernel: one is needed here because
// the port's training WN runs this gate, where an output launched through
// ctypes would otherwise cut the autograd graph. The no-grad WaveNets do not
// launch it: there the gate is the epilogue of kernel K2 (csrc/flow_coupling.cu).
//
// b is absent (a null pointer) or one [2H] row per batch row. Arithmetic is
// fp32; a, b and the outputs are float32 or bfloat16 (the input type).
//
// Bound: bytes. Forward reads 2H and writes H values a row; backward reads
// 3H and writes 2H. At the training WN's shapes (6,000 rows of 256) that is
// a few MB, microseconds at 3.35 TB/s.
// Design: a block owns rows of one batch row (grid y), and a thread owns a
// fixed group of VEC = 16 bytes of columns (4 fp32 or 8 bf16), so it loads
// its b values once and then, for each of its rows, both halves of its gate
// pairs as 16-byte vectors. Row and column indices are 32-bit, with no
// division per element; the grid is a few waves over the SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int WAVES = 4;  // blocks a grid: about this many per SM

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// 16 bytes of T as VEC floats, and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The thread's column group and first row, and the rows a step covers.
struct Layout {
  int c, r0, rstep;
};
template <typename T>
__device__ __forceinline__ bool layout(int H, Layout& lo) {
  const int groups = H / Vec<T>::N;  // threads a row
  const int rows = NTHREADS / groups;  // rows a block step
  lo.c = (threadIdx.x % groups) * Vec<T>::N;
  lo.r0 = blockIdx.x * rows + threadIdx.x / groups;
  lo.rstep = gridDim.x * rows;
  return (int)threadIdx.x < rows * groups;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gate_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int T_len,
                int H) {
  constexpr int N = Vec<T>::N;
  Layout lo;
  if (!layout<T>(H, lo)) return;
  const size_t bi = blockIdx.y;
  const T* ab = a + bi * T_len * 2 * H;
  T* ob = out + bi * T_len * H;
  float b1[N], b2[N];
  if (b != nullptr) {
    Vec<T>::load(b + bi * 2 * H + lo.c, b1);
    Vec<T>::load(b + bi * 2 * H + H + lo.c, b2);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) b1[i] = b2[i] = 0.f;
  }
  for (int t = lo.r0; t < T_len; t += lo.rstep) {
    float x1[N], x2[N], y[N];
    Vec<T>::load(ab + t * 2 * H + lo.c, x1);
    Vec<T>::load(ab + t * 2 * H + H + lo.c, x2);
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = tanhf(x1[i] + b1[i]) * sigmoid(x2[i] + b2[i]);
    Vec<T>::store(ob + t * H + lo.c, y);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gate_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ a,
                const T* __restrict__ b, T* __restrict__ grad_x, int T_len, int H) {
  constexpr int N = Vec<T>::N;
  Layout lo;
  if (!layout<T>(H, lo)) return;
  const size_t bi = blockIdx.y;
  const T* ab = a + bi * T_len * 2 * H;
  const T* gb = grad_out + bi * T_len * H;
  T* xb = grad_x + bi * T_len * 2 * H;
  float b1[N], b2[N];
  if (b != nullptr) {
    Vec<T>::load(b + bi * 2 * H + lo.c, b1);
    Vec<T>::load(b + bi * 2 * H + H + lo.c, b2);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) b1[i] = b2[i] = 0.f;
  }
  for (int t = lo.r0; t < T_len; t += lo.rstep) {
    float x1[N], x2[N], g[N], d1[N], d2[N];
    Vec<T>::load(ab + t * 2 * H + lo.c, x1);
    Vec<T>::load(ab + t * 2 * H + H + lo.c, x2);
    Vec<T>::load(gb + t * H + lo.c, g);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float th = tanhf(x1[i] + b1[i]), s = sigmoid(x2[i] + b2[i]);
      d1[i] = g[i] * s * (1.f - th * th);
      d2[i] = g[i] * th * s * (1.f - s);
    }
    Vec<T>::store(xb + t * 2 * H + lo.c, d1);
    Vec<T>::store(xb + t * 2 * H + H + lo.c, d2);
  }
}

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) !=
                           cudaSuccess)
    return 132;
  return sms[dev];
}

// Blocks along time for B batch rows: enough row steps to cover T, at most
// about WAVES blocks per SM over the whole grid.
template <typename T>
dim3 grid_for(int B, int T_len, int H) {
  const int rows = NTHREADS / (H / Vec<T>::N);
  const int need = (T_len + rows - 1) / rows;
  const int cap = (WAVES * sm_count() + B - 1) / B;
  return dim3(need < cap ? need : cap, B);
}

// H a multiple of the vector width with a row's threads in one block, and
// every offset inside a batch row within 32 bits.
template <typename T>
bool bad_args(int B, int T_len, int H) {
  return B < 1 || B > 65535 || T_len < 1 || H < Vec<T>::N || H % Vec<T>::N != 0 ||
         H / Vec<T>::N > NTHREADS || (long long)T_len * 2 * H >= (1LL << 31);
}

template <typename T>
cudaError_t fwd(const void* a, const void* b, void* out, int B, int T_len, int H,
                cudaStream_t s) {
  if (bad_args<T>(B, T_len, H)) return cudaErrorInvalidValue;
  gate_fwd_kernel<T><<<grid_for<T>(B, T_len, H), NTHREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), T_len, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* go, const void* a, const void* b, void* gx, int B, int T_len, int H,
                cudaStream_t s) {
  if (bad_args<T>(B, T_len, H)) return cudaErrorInvalidValue;
  gate_bwd_kernel<T><<<grid_for<T>(B, T_len, H), NTHREADS, 0, s>>>(
      static_cast<const T*>(go), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(gx), T_len, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Device pointers, all contiguous,
// 16-byte aligned and of one type, float32 (bf16 == 0) or bfloat16 (bf16 == 1):
//   a [B, T, 2H]; b null or [B, 2H]; out, grad_out [B, T, H]; grad_x [B, T, 2H].
// H a multiple of 4 (float32) or 8 (bfloat16), at most 1024 or 2048.
// Each returns the cudaError_t of its launch.
extern "C" int fused_gate_fwd(const void* a, const void* b, void* out, int B, int T_len, int H,
                              int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? fwd<__nv_bfloat16>(a, b, out, B, T_len, H, s)
                    : fwd<float>(a, b, out, B, T_len, H, s));
}

extern "C" int fused_gate_bwd(const void* grad_out, const void* a, const void* b, void* grad_x,
                              int B, int T_len, int H, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? bwd<__nv_bfloat16>(grad_out, a, b, grad_x, B, T_len, H, s)
                    : bwd<float>(grad_out, a, b, grad_x, B, T_len, H, s));
}
