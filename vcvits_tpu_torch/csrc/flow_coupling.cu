// One mean-only residual-coupling REVERSE pass, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/flow_pallas.py:_coupling_kernel
// (pallas_call in _coupling_reverse, flow_pallas.py:137). For one tile of
// frames it computes, with every intermediate on chip:
//   h    = (x0 . W_pre + b_pre) * mask
//   for each of L WaveNet layers:
//     acc  = b_in + cond + sum_{m} shift(h, m - (K-1)/2) . W_in[l, m]
//     a    = tanh(acc[:H]) * sigmoid(acc[H:])
//     rs   = a . W_rs[l] + b_rs[l]        (last layer packed into the skip half)
//     h    = (h + rs[:H]) * mask;  skip += rs[H:]
//   m    = ((skip * mask) . W_post + b_post) * mask
//   out  = [x0, (x1 - m) * mask]
// Weight norm, the speaker GEMV (`cond`) and the channel flip stay outside,
// as in the JAX package.
//
// Bound: about 786 K multiply-adds per frame at H=128, K=5, L=4 (2.9 GMAC for
// 4 couplings over 930 frames), so the fp32 CUDA-core rate bounds it; the
// activations are a few MB. Design: one block per (tile, batch row); a tile
// carries +-halo = L*(K-1)/2 real neighbour frames (zeros outside [0, T)),
// and only the centre frames are written. Thread (j, y) owns hidden channel j
// and its sigmoid partner j+H for one quarter of the tile's rows, so the gate
// runs in registers and the skip sum never leaves them; h (with zero margin
// rows for the conv), the gate output and x0 live in shared memory. Weights
// are read through L2, eight input channels' worth of loads issued before
// their FMAs so that their latency overlaps; each load feeds RPT rows.
// Small tiles keep many blocks in flight at B=1.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NY = 4;   // row groups per block: blockDim = (H, NY)
constexpr int CU = 8;   // hidden channels per unrolled step (H % CU == 0)

template <int RPT>
__global__ void __launch_bounds__(512)
coupling_reverse_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                        const float* __restrict__ cond,
                        const float* __restrict__ w_pre, const float* __restrict__ b_pre,
                        const float* __restrict__ w_in, const float* __restrict__ b_in,
                        const float* __restrict__ w_rs, const float* __restrict__ b_rs,
                        const float* __restrict__ w_post, const float* __restrict__ b_post,
                        float* __restrict__ out,
                        int T, int half, int H, int L, int K, int halo, int tile) {
  constexpr int R = NY * RPT;  // tile rows including both halos
  const int kpad = (K - 1) / 2;
  extern __shared__ float smem[];
  float* x0s = smem;                         // [R][half]
  float* hpad = x0s + R * half;              // [kpad + R + kpad][H], zero margins
  float* hs = hpad + kpad * H;               // row r of the tile at hs[r * H]
  float* gs = hpad + (R + 2 * kpad) * H;     // [R][H] gate output, then masked skip
  float* ms = gs + R * H;                    // [R]

  const int C2 = 2 * half;
  const int twoH = 2 * H;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - halo;  // frame of tile row 0
  const int j = threadIdx.x;
  const int rbase = threadIdx.y * RPT;
  const int tid = threadIdx.y * H + j;
  const int nthr = NY * H;
  const float* xb = x + (size_t)b * T * C2;

  for (int idx = tid; idx < R * half; idx += nthr) {
    const int r = idx / half, c = idx - r * half, t = t0 + r;
    x0s[idx] = (t >= 0 && t < T) ? xb[(size_t)t * C2 + c] : 0.f;
  }
  for (int r = tid; r < R; r += nthr) {
    const int t = t0 + r;
    ms[r] = (t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.f;
  }
  for (int idx = tid; idx < kpad * H; idx += nthr) {  // the conv's zero rows
    hpad[idx] = 0.f;
    hs[R * H + idx] = 0.f;
  }
  __syncthreads();

  {  // pre: 1x1 conv half -> H
    float acc[RPT];
    const float bp = b_pre[j];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = bp;
#pragma unroll 4
    for (int c = 0; c < half; ++c) {
      const float w = w_pre[c * H + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(x0s[(rbase + i) * half + c], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) hs[(rbase + i) * H + j] = acc[i] * ms[rbase + i];
  }
  __syncthreads();

  float skip[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) skip[i] = 0.f;

  for (int l = 0; l < L; ++l) {
    float at[RPT], as[RPT];
    float bt = b_in[l * twoH + j], bs = b_in[l * twoH + H + j];
    if (cond != nullptr) {
      const float* cb = cond + (size_t)b * L * twoH + l * twoH;
      bt += cb[j];
      bs += cb[H + j];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      at[i] = bt;
      as[i] = bs;
    }
    for (int m = 0; m < K; ++m) {
      const float* wl = w_in + (size_t)(l * K + m) * H * twoH;
      const float* hm = hs + (rbase + m - kpad) * H;
      for (int c0 = 0; c0 < H; c0 += CU) {
        float wt[CU], ws[CU];  // all loads of the step issued before any use
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          wt[u] = wl[(c0 + u) * twoH + j];
          ws[u] = wl[(c0 + u) * twoH + H + j];
        }
#pragma unroll
        for (int u = 0; u < CU; ++u) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float hv = hm[i * H + c0 + u];
            at[i] = fmaf(hv, wt[u], at[i]);
            as[i] = fmaf(hv, ws[u], as[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      gs[(rbase + i) * H + j] = tanhf(at[i]) * (1.f / (1.f + expf(-as[i])));
    __syncthreads();  // every read of h for this layer is done; gate is complete

    float rr[RPT], rk[RPT];
    const float br = b_rs[l * twoH + j], bk = b_rs[l * twoH + H + j];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      rr[i] = br;
      rk[i] = bk;
    }
    const float* wr = w_rs + (size_t)l * H * twoH;
    for (int c0 = 0; c0 < H; c0 += CU) {
      float w1[CU], w2[CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        w1[u] = wr[(c0 + u) * twoH + j];
        w2[u] = wr[(c0 + u) * twoH + H + j];
      }
#pragma unroll
      for (int u = 0; u < CU; ++u) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float g = gs[(rbase + i) * H + c0 + u];
          rr[i] = fmaf(g, w1[u], rr[i]);
          rk[i] = fmaf(g, w2[u], rk[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rbase + i;
      hs[r * H + j] = (hs[r * H + j] + rr[i]) * ms[r];
      skip[i] += rk[i];
    }
    __syncthreads();  // h updated before the next layer reads it; gs free
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) gs[(rbase + i) * H + j] = skip[i] * ms[rbase + i];
  __syncthreads();

  // post (1x1 conv H -> half) and the affine update, centre rows only
  for (int idx = tid; idx < tile * half; idx += nthr) {
    const int q = idx / half, c = idx - q * half;
    const int r = halo + q, t = t0 + r;
    if (t >= T) continue;
    float acc = b_post[c];
#pragma unroll 4
    for (int p = 0; p < H; ++p) acc = fmaf(gs[r * H + p], w_post[p * half + c], acc);
    const float mr = ms[r];
    const size_t o = ((size_t)b * T + t) * C2;
    out[o + c] = x0s[r * half + c];
    out[o + half + c] = (xb[(size_t)t * C2 + half + c] - acc * mr) * mr;
  }
}

template <int RPT>
cudaError_t launch(const float* x, const float* mask, const float* cond, const float* w_pre,
                   const float* b_pre, const float* w_in, const float* b_in, const float* w_rs,
                   const float* b_rs, const float* w_post, const float* b_post, float* out,
                   int B, int T, int half, int H, int L, int K, int halo, int tile,
                   cudaStream_t stream) {
  const int R = NY * RPT;
  const int kpad = (K - 1) / 2;
  const size_t smem = (size_t)(R * half + (R + 2 * kpad) * H + R * H + R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(coupling_reverse_kernel<RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + tile - 1) / tile, B);
  dim3 block(H, NY);
  coupling_reverse_kernel<RPT><<<grid, block, smem, stream>>>(
      x, mask, cond, w_pre, b_pre, w_in, b_in, w_rs, b_rs, w_post, b_post, out, T, half, H, L,
      K, halo, tile);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device pointers
// to contiguous float32 arrays:
//   x [B,T,2*half], mask [B,T], cond [B,L*2H] or null, w_pre [half,H],
//   b_pre [H], w_in [L,K,H,2H], b_in [L,2H], w_rs [L,H,2H], b_rs [L,2H],
//   w_post [H,half], b_post [half], out [B,T,2*half].
// tile + 2*L*(K-1)/2 must be 24, 32 or 48 rows, H a multiple of 8 with
// 4*H <= 512.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flow_coupling_reverse(const void* x, const void* mask, const void* cond,
                                     const void* w_pre, const void* b_pre, const void* w_in,
                                     const void* b_in, const void* w_rs, const void* b_rs,
                                     const void* w_post, const void* b_post, void* out, int B,
                                     int T, int half, int H, int L, int K, int tile,
                                     void* stream) {
  const int halo = L * ((K - 1) / 2);
  const int R = tile + 2 * halo;
  if (NY * H > 512 || H % CU != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VC_LAUNCH(RPT)                                                                      \
  launch<RPT>(static_cast<const float*>(x), static_cast<const float*>(mask),               \
              static_cast<const float*>(cond), static_cast<const float*>(w_pre),           \
              static_cast<const float*>(b_pre), static_cast<const float*>(w_in),           \
              static_cast<const float*>(b_in), static_cast<const float*>(w_rs),            \
              static_cast<const float*>(b_rs), static_cast<const float*>(w_post),          \
              static_cast<const float*>(b_post), static_cast<float*>(out), B, T, half, H, \
              L, K, halo, tile, s)
  switch (R) {
    case 24: return (int)VC_LAUNCH(6);
    case 32: return (int)VC_LAUNCH(8);
    case 48: return (int)VC_LAUNCH(12);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VC_LAUNCH
}
