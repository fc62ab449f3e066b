// Monotonic alignment search (MAS) for Hopper (sm_90a): kernel M1.
//
// Replaces vcvits_tpu/ops/monotonic_align.py:maximum_path, which is no
// Pallas kernel but two lax.scans over the T_y spectrogram frames (a DP
// forward over columns, then a backtrack). A direct PyTorch port is a loop
// of about 8 launches a frame, some 6,000 launches a TTS train step at
// 750 frames; here it is one launch.
//
// For batch row b with lengths xl = clamp(x_len, 0, T_x), yl = clamp(y_len,
// 0, T_y), the mask is m[x, y] = (x < xl) & (y < yl) and the scores are
// v[x, y] = m ? value[b, y, x] : -1e9 (value in the [B, T_y, T_x] layout of
// the text-prior log-likelihoods, so a column y is one coalesced row).
//   best_0[x]   = x == 0 ? v[0, 0] : -1e9
//   diag        = x == 0 ? -1e9 : best_{y-1}[x - 1]
//   fd_y[x]     = diag > best_{y-1}[x]                (strict, as JAX)
//   best_y[x]   = (fd_y[x] ? diag : best_{y-1}[x]) + v[x, y]
// Backtrack from x = max(xl, 1) - 1 at y = T_y - 1 down to 0: out[y] = x,
// then x -= 1 where 1 <= y <= max(yl, 1) - 1 and fd_y[x]. The path is
// path[b, x, y] = (x == out[y]) * m[x, y], float32, [B, T_x, T_y] (JAX's
// layout). Each sum is the one float32 add JAX's scan makes, in the same
// order, so the path is bit-identical to JAX's. A row with xl or yl 0 has
// an all-zero mask, and its path is all zero.
//
// Bound: bytes (a compare and an add a score): the scores of the valid
// region read once and the path written once, 18 MB at the TTS step's
// 16 x 192 x 750, about 6 us at 3.35 TB/s. The time is set by the T_y
// columns, which are serial: each costs a global load and a barrier.
// Design: one block per batch row; a thread owns x = tid + k * 256, so each
// warp holds 32 consecutive x. The DP column lives in shared memory,
// double-buffered, with one __syncthreads a column; the next column's
// scores are loaded into registers before the barrier. A warp's 32
// decisions of a column are one __ballot_sync word, stored in shared memory
// where T_y * ceil(T_x / 32) words fit (the TTS step's 18 KB) and in a
// global scratch of the same layout otherwise. One thread walks the
// backtrack into a shared array of x per column; then the block writes the
// path, coalesced along y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_PER_THREAD = 8;  // T_x <= 2048
constexpr float NEG_INF = -1e9f;
constexpr size_t SMEM_LIMIT = 200 * 1024;

__host__ __device__ inline int words_per_column(int t_x) { return (t_x + 31) / 32; }

// Shared bytes of the DP columns and the backtrack's x per column.
__host__ __device__ inline size_t base_smem(int t_y, int t_x) {
  return sizeof(float) * 2 * (size_t)t_x + sizeof(int) * (size_t)t_y;
}

template <bool SHARED_BITS>
__global__ void __launch_bounds__(NTHREADS)
    mas_kernel(const float* __restrict__ value, const int* __restrict__ x_len,
               const int* __restrict__ y_len, float* __restrict__ path,
               uint32_t* __restrict__ global_bits, int t_y, int t_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cols = reinterpret_cast<float*>(smem);  // two DP columns of t_x
  int* x_of_y = reinterpret_cast<int*>(smem + sizeof(float) * 2 * t_x);
  const int nw = words_per_column(t_x);
  const int b = blockIdx.x;
  uint32_t* bits = SHARED_BITS
                       ? reinterpret_cast<uint32_t*>(smem + base_smem(t_y, t_x))
                       : global_bits + (size_t)b * t_y * nw;
  const int xl = min(max(x_len[b], 0), t_x);
  const int yl = min(max(y_len[b], 0), t_y);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int per = (t_x + NTHREADS - 1) / NTHREADS;
  const float* vb = value + (size_t)b * t_y * t_x;
  float* pb = path + (size_t)b * t_x * t_y;

  if (xl == 0 || yl == 0) {
    for (size_t i = tid; i < (size_t)t_x * t_y; i += NTHREADS) pb[i] = 0.f;
    return;
  }

  // column 0, and the scores of column 1 in registers
  float v_next[MAX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k) {
    if (k < per) {
      const int x = tid + k * NTHREADS;
      if (x < t_x) cols[x] = x == 0 ? vb[0] : NEG_INF;
      v_next[k] = (x < xl && 1 < yl) ? vb[(size_t)t_x + x] : NEG_INF;
    }
  }
  __syncthreads();

  // The DP over the columns the backtrack reads (y < yl); later columns
  // only feed decisions it never takes.
  for (int y = 1; y < yl; ++y) {
    const float* prev = cols + ((y - 1) & 1) * t_x;
    float* cur = cols + (y & 1) * t_x;
    float v[MAX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) v[k] = v_next[k];
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      if (k < per) {
        const int x = tid + k * NTHREADS;
        bool fd = false;
        if (x < t_x) {
          const float stay = prev[x];
          const float diag = x == 0 ? NEG_INF : prev[x - 1];
          fd = diag > stay;
          cur[x] = __fadd_rn(fd ? diag : stay, v[k]);
        }
        const uint32_t word = __ballot_sync(0xffffffffu, fd);
        if (lane == 0 && x < t_x) bits[(size_t)y * nw + (x >> 5)] = word;
        v_next[k] = (x < xl && y + 1 < yl) ? vb[(size_t)(y + 1) * t_x + x] : NEG_INF;
      }
    }
    __syncthreads();
  }
  if (!SHARED_BITS) __threadfence_block();

  if (tid == 0) {
    int x = xl - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      x_of_y[y] = x;
      if (y >= 1 && y <= yl - 1) {
        const int xi = x < 0 ? x + t_x : x;
        if ((bits[(size_t)y * nw + (xi >> 5)] >> (xi & 31)) & 1u) x -= 1;
      }
    }
  }
  __syncthreads();

  for (int x = 0; x < t_x; ++x) {
    float* row = pb + (size_t)x * t_y;
    const bool in_x = x < xl;
    for (int y = tid; y < t_y; y += NTHREADS)
      row[y] = (in_x && y < yl && x_of_y[y] == x) ? 1.f : 0.f;
  }
}

}  // namespace

// Where the decisions live: 1 in shared memory, 0 in the global scratch
// (B * T_y * ceil(T_x / 32) words, which the caller then passes), -1 when
// even the DP columns do not fit, or T_x is above the kernel's limit.
extern "C" int monotonic_align_shared_bits(int t_y, int t_x) {
  if (t_x > NTHREADS * MAX_PER_THREAD || base_smem(t_y, t_x) > SMEM_LIMIT) return -1;
  return base_smem(t_y, t_x) + sizeof(uint32_t) * (size_t)t_y * words_per_column(t_x) <=
         SMEM_LIMIT;
}

extern "C" int monotonic_align(const void* value, const void* x_len, const void* y_len,
                               void* path, void* global_bits, int B, int t_y, int t_x,
                               void* stream) {
  const int shared_bits = monotonic_align_shared_bits(t_y, t_x);
  if (shared_bits < 0 || B <= 0 || t_y <= 0 || t_x <= 0) return (int)cudaErrorInvalidValue;
  if (!shared_bits && global_bits == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem = base_smem(t_y, t_x);
  if (shared_bits) smem += sizeof(uint32_t) * (size_t)t_y * words_per_column(t_x);
  smem = (smem + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = shared_bits ? mas_kernel<true> : mas_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NTHREADS, smem, s>>>(static_cast<const float*>(value),
                                   static_cast<const int*>(x_len),
                                   static_cast<const int*>(y_len), static_cast<float*>(path),
                                   static_cast<uint32_t*>(global_bits), t_y, t_x);
  return (int)cudaGetLastError();
}
