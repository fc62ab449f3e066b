// The WaveNet stack of a mean-only residual coupling, fp32, on Hopper's
// tensor cores across a thread-block cluster (sm_90a).
//
// Replaces the Pallas TPU kernel vcvits_tpu/ops/flow_pallas.py:_coupling_kernel
// (pallas_call in _coupling_reverse, flow_pallas.py:137). One launch runs, for
// every tile of frames and with every intermediate on chip, one of three
// modes on the same core:
//   REVERSE, FORWARD (one coupling, x = [x0, x1]):
//     h    = (x0 . W_pre + b_pre) * mask
//     WN   (below) on h, skip = 0
//     m    = ((skip * mask) . W_post + b_post) * mask
//     out  = [x0, (x1 - m) * mask]     REVERSE
//     out  = [x0, (m + x1) * mask]     FORWARD
//   WN_SEGMENT (L consecutive layers of a longer WaveNet, no pre or post):
//     WN on (h_in, skip_in) -> (h_out, skip_out)
// where WN is, for each layer l:
//     acc  = b_in[l] + cond[l] + sum_m shift(h, m - (K-1)/2) . W_in[l, m]
//     a    = tanh(acc[:H]) * sigmoid(acc[H:])
//     rs   = a . W_rs[l] + b_rs[l]        (a WaveNet's last layer packed into the skip half)
//     h    = (h + rs[:H]) * mask;  skip += rs[H:]
// Weight norm, the speaker GEMV (`cond`), the channel flip and the final
// skip * mask of a WaveNet stay outside, as in the JAX package.
//
// Bound: 2 * (pre + L * (K H 2H + H 2H) + post) flops a frame, 5.85 GFLOP for
// the 4 couplings of a 10 s request at H = 128 (930 frames); as 3xTF32 on
// the tensor cores (three TF32 products a multiply-add), 0.0355 ms at
// 495 TFLOP/s. The activations are a few MB and the weights 3.2 MB a
// coupling, which the L2 holds.
//
// Design:
// * A tile is ROWS = 80 frame rows: a centre of 80 - 2 halo rows and a halo
//   of L (K-1)/2 real neighbour frames on each side (64 + 2 x 8 for L = 4,
//   K = 5), zeros outside [0, T) (mask 0 there, so h stays 0). Only the
//   centre is written. The conv reads (K-1)/2 zero margin rows above and
//   below the tile; each layer spoils (K-1)/2 more edge rows, all in the halo.
// * A tile runs on a cluster of n CTAs: CTA q owns the P = H / n hidden
//   channels [qP, (q+1)P) (P = 16 up to H = 128, else 32), their sigmoid
//   partners j + H, the same slice of res_skip's res and skip halves, and of
//   pre's outputs. Each CTA keeps a full copy of h and of the gate output in
//   shared memory, blocked by owner: block q holds channels [qP, (q+1)P) of
//   every row, so a CTA's slice is one contiguous run. After a layer's gate,
//   and again after its h update, a CTA sends its block to every peer with
//   one bulk copy each (cp.async.bulk shared::cluster, the copy engine), which
//   completes on the peer's mbarrier; a CTA waits on its own mbarrier for its
//   peers' blocks. That wait is the only synchronisation between CTAs inside
//   the layers: a CTA sends into a peer's copy only after that peer has sent
//   it data it produced after its last read of that copy. Each CTA streams
//   only its slice of the weights from L2.
// * The products are 3xTF32 mma.sync m16n8k8 (csrc/tf32_mma.cuh): 8 warps,
//   warp w owns pair group w % (P/8) (8 tanh columns and their 8 sigmoid
//   columns; for res_skip 8 res and 8 skip columns) over all 80 rows, and
//   the input-channel share w / (P/8) of every weight tile (split K). Each
//   weight tile's products go into a fresh partial sum added in fp32. A tap
//   shifts A by m rows, so A is unswizzled, row-major in each block with a
//   padded stride (P + 4), conflict-free at any row.
// * The split-K partial sums meet in a scratch that aliases the h copy
//   (for the conv; a CTA keeps its own h columns in registers) or the gate
//   copy (for res_skip): no peer sends into either until this CTA has sent
//   what follows. Then every thread finishes whole (tanh, sigmoid) or
//   (res, skip) pairs: the gate, and the h update with skip kept in
//   registers, are the epilogue of the products.
// * Weights: per layer K + 1 slices of [H input channels x 2P columns]
//   (W_in[l, m]'s tanh and sigmoid columns, then W_rs[l]'s res and skip
//   columns), in tiles of KC input channels through a 2-deep cp.async ring
//   that runs across layers, so the next tile loads while one multiplies.
// * Pre and post (1x1 convs over half channels) are fp32 FMAs: pre for the
//   CTA's h columns, post for every n-th centre row after the skip sums
//   are exchanged like h.
// * Shared memory (`plan`, mirrored by ops/flow_coupling.py:plan): the h copy
//   with its margins, the gate copy (each at least the 40 KB scratch), the
//   ring, the CTA's biases (the speaker term added) of every layer, the mask
//   and two mbarriers: 147,280 bytes at H = 128, 228,176 at H = 256 (L = 4);
//   the launch is refused above 227 KB, and when no cluster of n such CTAs
//   fits the card (cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 80;       // tile rows, halo included
constexpr int MT = ROWS / 16;  // m16 tiles over the rows
constexpr int NTHREADS = 256;  // 8 warps
constexpr int MAX_SMEM = 232448;
constexpr int STAGES = 2;      // weight ring depth (3 measured no faster on the H100)
constexpr int SCRATCH_FLOATS = 8 * MT * 2 * 4 * 32;  // every warp's partial sums

enum Mode { REVERSE = 0, FORWARD = 1, WN_SEGMENT = 2 };

struct Plan {
  int pairs;    // P: hidden channels a CTA owns
  int cluster;  // n = H / P CTAs a tile
  int kc;       // input channels a weight tile
  int halo;     // L (K-1)/2
  int tile;     // centre rows: ROWS - 2 halo
  int hregion;  // bytes: h copy (and the conv's scratch, the skip for post)
  int gregion;  // bytes: gate copy (x0 for pre, the res scratch)
  int ring;     // bytes: the weight ring
  int smem;     // bytes in all
};

__host__ __device__ inline int round128(int v) { return (v + 127) / 128 * 128; }

// The launch's shape; false where the kernel does not take the size.
// ops/flow_coupling.py:plan mirrors this.
__host__ __device__ inline bool make_plan(int H, int K, int L, int half, int mode, Plan* p) {
  if (H % 64 != 0 || H < 64 || H > 256 || K < 1 || K % 2 == 0 || L < 1) return false;
  if (mode < REVERSE || mode > WN_SEGMENT) return false;
  if (mode != WN_SEGMENT && (half < 4 || half % 4 != 0 || half > H)) return false;
  p->pairs = H <= 128 ? 16 : 32;
  p->cluster = H / p->pairs;
  p->kc = p->pairs == 16 ? (H < 128 ? H : 128) : 64;
  p->halo = L * ((K - 1) / 2);
  p->tile = ROWS - 2 * p->halo;
  if (p->tile < 16) return false;
  const int pb = p->pairs + 4;  // a block's row stride
  const int scratch = SCRATCH_FLOATS * 4;
  const int hbytes = p->cluster * (ROWS + K - 1) * pb * 4;
  const int gbytes = p->cluster * ROWS * pb * 4;
  p->hregion = round128(hbytes > scratch ? hbytes : scratch);
  p->gregion = round128(gbytes > scratch ? gbytes : scratch);
  p->ring = STAGES * p->kc * (2 * p->pairs + 8) * 4;
  p->smem = p->hregion + p->gregion + p->ring + 4 * L * p->pairs * 4 + ROWS * 4 + 16;
  return p->smem <= MAX_SMEM;
}

struct Args {
  const float* x;        // REVERSE/FORWARD: x [B, T, 2 half]; WN_SEGMENT: h_in [B, T, H]
  const float* skip_in;  // WN_SEGMENT: [B, T, H]
  const float* mask;     // [B, T]
  const float* cond;     // [B, L 2H] or null
  const float *w_pre, *b_pre, *w_in, *b_in, *w_rs, *b_rs, *w_post, *b_post;
  float* out;       // REVERSE/FORWARD: [B, T, 2 half]; WN_SEGMENT: h_out [B, T, H]
  float* skip_out;  // WN_SEGMENT: [B, T, H]
  int T, half, H, L, K, mode;
  Plan plan;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // acquire
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tc::smem_addr(bar)) : "memory");
}
// This CTA's one arrival on `bar` for the current phase, which also expects
// `bytes` from the copies that complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
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
      "}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Threads 0 .. n-2 each copy this CTA's block (`bytes` at `own`) into the
// same place of one peer, completing on that peer's `bar`. The block's
// shared-memory writes must be complete (fence and __syncthreads before).
__device__ __forceinline__ void send_block(const float* own, uint32_t bytes, uint64_t* bar,
                                           int n, int rank) {
  const int k = threadIdx.x;
  if (k >= n - 1) return;
  const uint32_t peer = k + (k >= rank), src = tc::smem_addr(own);
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(src), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(tc::smem_addr(bar)), "r"(peer));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(rbar)
      : "memory");
}

// Make this CTA's generic-proxy shared-memory writes visible to the copy
// engine, then let every thread past them.
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Pair e (of ROWS x P, e = thread + NTHREADS i) <-> row and column in the
// CTA's slice, as the mma C fragment of pair group e >> 7 / MT, m tile
// (e >> 7) % MT, register (e >> 5) & 3 and lane e & 31 holds it.
__device__ __forceinline__ void pair_pos(int e, int& row, int& col) {
  const int ln = e & 31, reg = (e >> 5) & 3, mt = (e >> 7) % MT, grp = (e >> 7) / MT;
  row = mt * 16 + (ln >> 2) + 8 * (reg >> 1);
  col = grp * 8 + 2 * (ln & 3) + (reg & 1);
}

// Scratch slot of warp part `ks`, pair group and m tile `gm` (= grp MT + mt),
// half `ab` (0 tanh / res, 1 sigmoid / skip), register and lane.
template <int NP>
__device__ __forceinline__ int scratch_at(int ks, int gm, int ab, int reg_lane) {
  return ((ks * NP * MT + gm) * 2 + ab) * 128 + reg_lane;
}

// Weight tile s of the launch: layer s / NS; within it, tiles j < K NCB are
// W_in[l, j / NCB] and j >= K NCB W_rs[l], input channels (j % NCB) KC ..
// + KC; columns this CTA's tanh (res) slice, then its sigmoid (skip) slice.
template <int P>
__device__ __forceinline__ void load_tile(float* dst, const Args& a, int s, int col0) {
  const int H = a.H, K = a.K, KC = a.plan.kc, NCB = H / KC, NS = (K + 1) * NCB;
  const int l = s / NS, j = s - l * NS;
  const float* src = j < K * NCB
                         ? a.w_in + ((size_t)(l * K + j / NCB) * H + (j % NCB) * KC) * 2 * H
                         : a.w_rs + ((size_t)l * H + (j - K * NCB) * KC) * 2 * H;
  constexpr int C4 = P / 4, WS = 2 * P + 8;
  for (int i = threadIdx.x; i < KC * 2 * C4; i += NTHREADS) {
    const int r = i / (2 * C4), c = i - r * (2 * C4);
    const int from = c < C4 ? col0 + 4 * c : H + col0 + 4 * (c - C4);
    tc::cp_async16(dst + r * WS + 4 * c, src + (size_t)r * 2 * H + from);
  }
}

// acc[mt][ab] += A[rows, ch0 .. ch0 + CW] . tile[wrow0 .. + CW, ab P + grp 8 ..]
// for the warp's 80 rows and its pair group's two column blocks. A is a
// blocked copy: channel c of row r at A[(c / P) bs + r PB + c % P].
template <int P, int CW>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][2][4], const float* A, int bs,
                                         const float* tile, int ch0, int wrow0, int grp,
                                         int lane) {
  constexpr int WS = 2 * P + 8, PB = P + 4;
  const int g = lane >> 2, q = lane & 3;
  float part[MT][2][4];
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk) {
    const int ch = ch0 + 8 * kk;
    const float* ak = A + (ch / P) * bs + ch % P + g * PB + q;
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int ab = 0; ab < 2; ++ab)
      tc::load_b_split(tile + (wrow0 + 8 * kk + q) * WS + ab * P + grp * 8 + g, WS, bh[ab],
                       bl[ab]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ah[4], al[4];
      tc::load_a_split(ak + mt * 16 * PB, PB, ah, al);
#pragma unroll
      for (int ab = 0; ab < 2; ++ab) tc::mma_3xtf32(part[mt][ab], ah, al, bh[ab], bl[ab], kk == 0);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ab = 0; ab < 2; ++ab)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][ab][i] += part[mt][ab][i];
}

template <int P, int CW>
__global__ void __launch_bounds__(NTHREADS, 1) wn_stack_kernel(const __grid_constant__ Args a) {
  constexpr int NP = P / 8;         // pair groups
  constexpr int KS = 8 / NP;        // split-K parts
  constexpr int NE = ROWS * P / NTHREADS;  // pairs a thread finishes
  constexpr int WS = 2 * P + 8;
  constexpr int PB = P + 4;         // row stride of a block of the h and gate copies
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();

  const Plan pl = a.plan;
  const int H = a.H, K = a.K, L = a.L, T = a.T, kpad = (K - 1) / 2;
  const int n = pl.cluster, rank = (int)cluster.block_rank();
  const int col0 = rank * P;
  const int b = blockIdx.y;
  const int t_first = (blockIdx.x / n) * pl.tile - pl.halo;  // frame of tile row 0
  const int HB = (ROWS + K - 1) * PB, GB = ROWS * PB;         // block strides
  float* hcopy = reinterpret_cast<float*>(smem_raw);          // n x [ROWS + K - 1][PB]
  float* gcopy = reinterpret_cast<float*>(smem_raw + pl.hregion);  // n x [ROWS][PB]
  float* ring = reinterpret_cast<float*>(smem_raw + pl.hregion + pl.gregion);
  float* bias = ring + pl.ring / 4;  // per layer: gate (b_in + cond) tanh, sigmoid; b_rs res, skip
  float* ms = bias + 4 * L * P;
  uint64_t* bar_h = reinterpret_cast<uint64_t*>(ms + ROWS);  // peers' h (and skip) blocks
  uint64_t* bar_g = bar_h + 1;                               // peers' gate blocks
  float* hown = hcopy + rank * HB + kpad * PB;  // this CTA's h block, tile row 0
  float* gown = gcopy + rank * GB;
  const uint32_t block_bytes = ROWS * PB * 4, expect = (n - 1) * block_bytes;
  uint32_t ph_h = 0, ph_g = 0;  // the phase each mbarrier waits on next
  const int tile_floats = pl.kc * WS;
  const int NCB = H / pl.kc, NS = (K + 1) * NCB, n_tiles = L * NS;
  const bool coupling = a.mode != WN_SEGMENT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp % NP, ks = warp / NP;

  if (tid == 0) {
    mbar_init(bar_h);
    mbar_init(bar_g);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();  // matched by the wait before the first copy to a peer

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile<P>(ring + s * tile_floats, a, s, col0);
    tc::cp_commit();
  }

  for (int r = tid; r < ROWS; r += NTHREADS) {
    const int t = t_first + r;
    ms[r] = t >= 0 && t < T ? a.mask[(size_t)b * T + t] : 0.f;
  }
  for (int i = tid; i < 4 * L * P; i += NTHREADS) {  // this CTA's columns of every layer
    const int l = i / (4 * P), part = (i / P) % 4, c = col0 + i % P + (part & 1) * H;
    float v = (part < 2 ? a.b_in : a.b_rs)[l * 2 * H + c];
    if (part < 2 && a.cond != nullptr) v += a.cond[(size_t)b * L * 2 * H + l * 2 * H + c];
    bias[i] = v;
  }
  auto zero_margins = [&]() {  // the conv's zero rows above and below every block
    for (int i = tid; i < n * kpad * PB; i += NTHREADS) {
      const int q = i / (kpad * PB), j = i - q * (kpad * PB);
      hcopy[q * HB + j] = 0.f;
      hcopy[q * HB + (kpad + ROWS) * PB + j] = 0.f;
    }
  };
  zero_margins();
  const int xs = a.half + 4;  // row stride of x0 staged in the gate copy
  if (coupling) {
    for (int i = tid; i < ROWS * (a.half / 4); i += NTHREADS) {
      const int r = i / (a.half / 4), c = 4 * (i - r * (a.half / 4)), t = t_first + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T)
        v = *reinterpret_cast<const float4*>(a.x + ((size_t)b * T + t) * 2 * a.half + c);
      *reinterpret_cast<float4*>(gcopy + r * xs + c) = v;
    }
  } else {  // h_in, every block
    for (int i = tid; i < ROWS * (H / 4); i += NTHREADS) {
      const int r = i / (H / 4), c = 4 * (i - r * (H / 4)), t = t_first + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) v = *reinterpret_cast<const float4*>(a.x + ((size_t)b * T + t) * H + c);
      *reinterpret_cast<float4*>(hcopy + (c / P) * HB + (r + kpad) * PB + c % P) = v;
    }
  }
  float h_r[NE], skip_r[NE];  // this thread's pairs: h (own columns) and the skip sum
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    int row, col;
    pair_pos(tid + NTHREADS * i, row, col);
    const int t = t_first + row;
    skip_r[i] = !coupling && t >= 0 && t < T
                    ? a.skip_in[((size_t)b * T + t) * H + col0 + col] : 0.f;
  }
  __syncthreads();
  if (coupling) {  // pre, this CTA's h columns (NE independent sums), then the exchange
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      int row, col;
      pair_pos(tid + NTHREADS * i, row, col);
      h_r[i] = a.b_pre[col0 + col];
    }
    for (int c = 0; c < a.half; c += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          int row, col;
          pair_pos(tid + NTHREADS * i, row, col);
          h_r[i] = fmaf(gcopy[row * xs + c + u], __ldg(a.w_pre + (c + u) * H + col0 + col),
                        h_r[i]);
        }
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      int row, col;
      pair_pos(tid + NTHREADS * i, row, col);
      h_r[i] *= ms[row];
      hown[row * PB + col] = h_r[i];
    }
    publish();
    cluster_wait();
    if (tid == 0) mbar_expect(bar_h, expect);
    send_block(hown, block_bytes, bar_h, n, rank);
    mbar_wait(bar_h, ph_h);
    ph_h ^= 1;
  } else {
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      int row, col;
      pair_pos(tid + NTHREADS * i, row, col);
      h_r[i] = hown[row * PB + col];
    }
    cluster_wait();
  }

  int s = 0;  // the next weight tile to multiply
  auto next_tile = [&]() -> const float* {
    tc::cp_wait<STAGES - 2>();
    __syncthreads();  // tile s has landed for every thread; tile s - 1 is free
    const int ahead = s + STAGES - 1;
    if (ahead < n_tiles) load_tile<P>(ring + (ahead % STAGES) * tile_floats, a, ahead, col0);
    tc::cp_commit();
    return ring + (s++ % STAGES) * tile_floats;
  };
  const int gm0 = tid >> 7;  // pair e's group-and-m-tile index is gm0 + 2 i
  float acc[MT][2][4];

  for (int l = 0; l < L; ++l) {
    // ---- dilated conv (dilation 1): K taps over the h copy
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ab = 0; ab < 2; ++ab)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][ab][i] = 0.f;
    for (int j = 0; j < K * NCB; ++j) {
      const float* w = next_tile();
      mma_tile<P, CW>(acc, hcopy + (j / NCB) * PB, HB, w, (j % NCB) * pl.kc + ks * CW, ks * CW,
                      grp, lane);
    }
    __syncthreads();  // every warp is done reading the h copy: it becomes the scratch
    float* scr = hcopy;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ab = 0; ab < 2; ++ab)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          scr[scratch_at<NP>(ks, grp * MT + mt, ab, i * 32 + lane)] = acc[mt][ab][i];
    __syncthreads();
    {  // the gate, this CTA's columns, into its block of the gate copy
      const float* bl = bias + l * 4 * P;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        int row, col;
        pair_pos(tid + NTHREADS * i, row, col);
        float xt = bl[col], xs2 = bl[P + col];
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          xt += scr[scratch_at<NP>(k, gm0 + 2 * i, 0, tid & 127)];
          xs2 += scr[scratch_at<NP>(k, gm0 + 2 * i, 1, tid & 127)];
        }
        gown[row * PB + col] = tanhf(xt) * sigmoid(xs2);
      }
    }
    __syncthreads();  // the scratch is read
    zero_margins();   // the scratch ran over them
    publish();
    if (tid == 0) mbar_expect(bar_g, expect);
    send_block(gown, block_bytes, bar_g, n, rank);
    mbar_wait(bar_g, ph_g);  // every peer's gate block is here
    ph_g ^= 1;

    // ---- res_skip (1x1) over the gate copy
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ab = 0; ab < 2; ++ab)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][ab][i] = 0.f;
    for (int j = 0; j < NCB; ++j) {
      const float* w = next_tile();
      mma_tile<P, CW>(acc, gcopy, GB, w, j * pl.kc + ks * CW, ks * CW, grp, lane);
    }
    __syncthreads();  // every warp is done reading the gate copy: it becomes the scratch
    scr = gcopy;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ab = 0; ab < 2; ++ab)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          scr[scratch_at<NP>(ks, grp * MT + mt, ab, i * 32 + lane)] = acc[mt][ab][i];
    __syncthreads();
    {  // h update and skip sum, this CTA's columns
      const float* bl = bias + l * 4 * P + 2 * P;
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        int row, col;
        pair_pos(tid + NTHREADS * i, row, col);
        float res = bl[col], sk = bl[P + col];
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          res += scr[scratch_at<NP>(k, gm0 + 2 * i, 0, tid & 127)];
          sk += scr[scratch_at<NP>(k, gm0 + 2 * i, 1, tid & 127)];
        }
        h_r[i] = (h_r[i] + res) * ms[row];
        skip_r[i] += sk;
        if (l < L - 1) hown[row * PB + col] = h_r[i];
      }
    }
    if (l < L - 1) {
      publish();
      if (tid == 0) mbar_expect(bar_h, expect);
      send_block(hown, block_bytes, bar_h, n, rank);
      mbar_wait(bar_h, ph_h);  // every peer's h block is here
      ph_h ^= 1;
    }
  }

  if (!coupling) {  // h and skip out, centre rows
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      int row, col;
      pair_pos(tid + NTHREADS * i, row, col);
      const int t = t_first + row;
      if (row < pl.halo || row >= pl.halo + pl.tile || t >= T) continue;
      const size_t o = ((size_t)b * T + t) * H + col0 + col;
      a.out[o] = h_r[i];
      a.skip_out[o] = skip_r[i];
    }
    cluster_arrive();  // no CTA leaves while a copy into or out of it may run
    cluster_wait();
    return;
  }

  // skip * mask into this CTA's h block (no peer sends h any more; each has
  // received this CTA's last gate block, sent after its last use of the h
  // copy), then the exchange
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    int row, col;
    pair_pos(tid + NTHREADS * i, row, col);
    hown[row * PB + col] = skip_r[i] * ms[row];
  }
  publish();
  if (tid == 0) mbar_expect(bar_h, expect);
  send_block(hown, block_bytes, bar_h, n, rank);
  mbar_wait(bar_h, ph_h);

  // post and the affine update: centre rows rank, rank + n, ..., four
  // independent sums a row over the skip channels
  const int half = a.half, rows_mine = (pl.tile - rank + n - 1) / n;
  for (int idx = tid; idx < rows_mine * half; idx += NTHREADS) {
    const int jj = rank + (idx / half) * n, c = idx % half;
    const int r = pl.halo + jj, t = t_first + r;
    if (t >= T) continue;
    float part4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < n; ++q) {
      const float* sk = hcopy + q * HB + (r + kpad) * PB;
      const float* wp = a.w_post + (size_t)q * P * half + c;
#pragma unroll
      for (int p = 0; p < P; p += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part4[u] = fmaf(sk[p + u], __ldg(wp + (p + u) * half), part4[u]);
    }
    const float acc1 = a.b_post[c] + ((part4[0] + part4[1]) + (part4[2] + part4[3]));
    const float mr = ms[r];
    const size_t o = ((size_t)b * T + t) * 2 * half;
    const float x1 = a.x[o + half + c];
    a.out[o + c] = a.x[o + c];
    a.out[o + half + c] = a.mode == REVERSE ? (x1 - acc1 * mr) * mr : (acc1 * mr + x1) * mr;
  }
  cluster_arrive();  // no CTA leaves while a copy into or out of it may run
  cluster_wait();
}

template <int P, int CW>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  // per device: the dynamic shared memory the kernel is allowed so far, and
  // the (smem, cluster) a cluster was found to fit with
  static int smem_set[64] = {}, fits_for[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const Plan& pl = args.plan;
  auto kern = wn_stack_kernel<P, CW>;
  if (pl.smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = pl.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((args.T + pl.tile - 1) / pl.tile * pl.cluster, B, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (pl.smem * 64 + pl.cluster != fits_for[dev]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fits_for[dev] = pl.smem * 64 + pl.cluster;
  }
  err = cudaLaunchKernelEx(&cfg, kern, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch shape for hidden H, kernel K, L layers, half channels and mode
// (0 reverse, 1 forward, 2 WaveNet segment): CTAs a cluster, centre frames a
// tile and dynamic shared-memory bytes. Returns 0, or cudaErrorInvalidValue
// where the kernel does not take the size.
extern "C" int flow_plan(int H, int K, int L, int half, int mode, int* cluster, int* tile,
                         int* smem) {
  Plan p;
  if (!make_plan(H, K, L, half, mode, &p)) return (int)cudaErrorInvalidValue;
  *cluster = p.cluster;
  *tile = p.tile;
  *smem = p.smem;
  return 0;
}

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// float32 arrays, 16-byte aligned:
//   mode 0/1: x [B,T,2*half], out [B,T,2*half] (not x), w_pre [half,H],
//             b_pre [H], w_post [H,half], b_post [half]; skip_in, skip_out null
//   mode 2:   x = h_in [B,T,H], skip_in [B,T,H], out = h_out [B,T,H],
//             skip_out [B,T,H] (neither an input); pre and post null
//   mask [B,T], cond [B,L*2H] or null, w_in [L,K,H,2H], b_in [L,2H],
//   w_rs [L,H,2H], b_rs [L,2H].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flow_wn_stack(int mode, const void* x, const void* skip_in, const void* mask,
                             const void* cond, const void* w_pre, const void* b_pre,
                             const void* w_in, const void* b_in, const void* w_rs,
                             const void* b_rs, const void* w_post, const void* b_post, void* out,
                             void* skip_out, int B, int T, int half, int H, int L, int K,
                             void* stream) {
  Args a;
  if (!make_plan(H, K, L, half, mode, &a.plan) || B < 1 || B > 65535 || T < 1)
    return (int)cudaErrorInvalidValue;
  const bool coupling = mode != WN_SEGMENT;
  if (x == nullptr || mask == nullptr || w_in == nullptr || b_in == nullptr || w_rs == nullptr ||
      b_rs == nullptr || out == nullptr || out == x)
    return (int)cudaErrorInvalidValue;
  if (coupling ? (w_pre == nullptr || b_pre == nullptr || w_post == nullptr ||
                  b_post == nullptr)
               : (skip_in == nullptr || skip_out == nullptr || skip_out == skip_in ||
                  skip_out == x || out == skip_in))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(x);
  a.skip_in = static_cast<const float*>(skip_in);
  a.mask = static_cast<const float*>(mask);
  a.cond = static_cast<const float*>(cond);
  a.w_pre = static_cast<const float*>(w_pre);
  a.b_pre = static_cast<const float*>(b_pre);
  a.w_in = static_cast<const float*>(w_in);
  a.b_in = static_cast<const float*>(b_in);
  a.w_rs = static_cast<const float*>(w_rs);
  a.b_rs = static_cast<const float*>(b_rs);
  a.w_post = static_cast<const float*>(w_post);
  a.b_post = static_cast<const float*>(b_post);
  a.out = static_cast<float*>(out);
  a.skip_out = static_cast<float*>(skip_out);
  a.T = T;
  a.half = coupling ? half : 0;
  a.H = H;
  a.L = L;
  a.K = K;
  a.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.plan.pairs == 32) return (int)launch<32, 32>(a, B, s);
  if (a.plan.kc == 128) return (int)launch<16, 32>(a, B, s);
  return (int)launch<16, 16>(a, B, s);
}
