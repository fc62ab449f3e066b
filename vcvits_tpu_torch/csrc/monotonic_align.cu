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
// the text-prior log-likelihoods, so a column y is one contiguous row).
//   best_0[x]   = x == 0 ? v[0, 0] : -1e9
//   diag        = x == 0 ? -1e9 : best_{y-1}[x - 1]
//   fd_y[x]     = diag > best_{y-1}[x]                (strict, as JAX)
//   best_y[x]   = (fd_y[x] ? diag : best_{y-1}[x]) + v[x, y]
// Backtrack from x = xl - 1 at y = T_y - 1 down to 0: out[y] = x, then
// x -= 1 where 1 <= y <= yl - 1 and fd_y[x] under JAX's gather rule (x < 0
// reads x + T_x, x < -T_x reads True). The path is path[b, x, y] = (x == out[y]) * m[x, y],
// float32, [B, T_x, T_y] (JAX's layout). Each sum is the one float32 add
// JAX's scan makes, so any split of x over lanes gives JAX's path bit for
// bit. A row with xl or yl 0 has an all-zero mask, and its path is all zero.
//
// Bound: bytes (a compare and an add a score): the valid scores read once
// and the path written once, 13.8 MB at the TTS step's ragged 16 x 192 x
// 750, about 4 us at 3.35 TB/s. The time is set by two serial chains a row,
// not by bytes: the DP's T_y dependent column steps, and the backtrack's
// T_y dependent lookups. The first design (one 256-thread block a row, the
// column in shared memory, one block barrier and a global load a column)
// took 4x this one's time at 16 x 192 x 750 (H100 80GB HBM3, 700 W;
// tools/torch_kernel_variants.py monotonic_align). This one:
//
// * A warp-synchronous DP. DP warp w owns x in [32 R w, 32 R (w + 1)), R
//   consecutive positions a lane, its column in registers. A lane's first
//   `diag` is one __shfl_up_sync from the lane below, issued a column ahead
//   (the last x goes first); the column needs no barrier. R (8 or 16) and
//   the warps come from the wrapper's plan. A lane's scores for the next
//   column load while it computes this one.
// * A skewed pipeline over warps where T_x passes one warp: warp w runs
//   column y once warp w - 1 has published best_{y-1} at its last x, a
//   (value, column) pair in one 64-bit word of a ring in shared memory; the
//   column tag is the flag, so a word is read once and no fence is needed.
//   Warp w trails warp w - 1 by about a column.
// * Scores staged ahead: a copy warp brings chunks of C columns into a ring
//   of S stages in shared memory, one full and one empty mbarrier a stage:
//   one bulk copy (TMA) a column of the 16-byte aligned [0, xl & ~3), the
//   last 0-3 scores loaded into the copy warp's registers a chunk ahead
//   (where T_x % 4 != 0 its threads copy the chunk). Positions [xl, 32 R W)
//   of every slot hold -1e9 from the start and are never copied. The DP
//   reads only shared memory.
// * Decisions as bits: a lane stores its R decisions as one byte or
//   halfword, so a column's bits are x-linear words, in
//   shared memory where T_y of them fit beside the ring, else in a global
//   scratch of the same layout.
// * The backtrack by one warp from registers: a window of 16 columns'
//   32-bit slices of those words, [X - 31, X] for the x = X at the start of
//   the window before (x falls by at most 1 a column), a lane a column,
//   loaded one window ahead and shuffled to every lane. A step covers two
//   columns: the first column's bit and the second's bits at x and x - 1
//   from shifts of registers, then one pick. Lane j stores the window's
//   column j's 1 (one predicated store a window).
// * The path's zeros off the DP's SM: a row runs on a cluster of G blocks;
//   blocks 1..G-1 zero the row's [T_x, T_y] stripe by stripe with 16-byte
//   stores while block 0 runs the DP, then arrive on the cluster barrier
//   that block 0 waits on before its first 1 (G = 1: block 0 zeroes the row
//   after its DP).
//
// Built with -DMAS_CLOCKS, the kernel also adds clock64 counts per phase to
// mas_clocks[b] (monotonic_align_clocks reads and clears them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e9f;
constexpr int SMEM_LIMIT = 232448;  // the shared memory a Hopper block may use
constexpr int MAX_DP_WARPS = 15;    // + the copy warp: 512 threads
constexpr int MIN_WARPS = 8;        // a block's warps at least (the zeroing blocks' stores)
constexpr int MAX_CLUSTER = 8;
constexpr int WINDOW = 16;          // backtrack columns a window
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Args {
  const float* value;
  const int* x_len;
  const int* y_len;
  float* path;
  uint32_t* gbits;  // [B, T_y, words] when the decisions are not in shared memory
  int t_y, t_x;
  int warps;    // DP warps
  int stages;   // ring stages
  int cols;     // columns a stage
  int cluster;  // blocks a row
  int slots;    // handoff words a warp (a power of two above stages * cols)
};

// Shared memory: the ring | the decisions (shared_bits) | handoff words | mbarriers.
struct Layout {
  long long ring, bits, bnd, bar, total;
};

__host__ __device__ inline Layout layout(int R, int warps, int stages, int cols, int slots,
                                         int t_y, int shared_bits) {
  Layout l;
  l.ring = 0;
  l.bits = (long long)stages * cols * warps * 32 * R * 4;
  const long long bits = shared_bits ? ((long long)t_y * warps * R * 4 + 15) / 16 * 16 : 0;
  l.bnd = l.bits + bits;
  l.bar = l.bnd + (long long)(warps - 1) * slots * 8;
  l.total = l.bar + 2LL * stages * 8;
  return l;
}

#ifdef MAS_CLOCKS
constexpr int CLOCK_ROWS = 64;
constexpr int CLOCKS = 14;
// per row: 0 setup, 1 DP loads waited on (warp 0), 2 handoff waits (last DP
// warp), 3 DP loop (warp 0), 4 DP loop (last DP warp), 5 block barrier after
// the DP (thread 0), 6 cluster wait before the 1s, 7 backtrack and 1s, 8
// zeroing (the slowest zeroing block), 9 block 0 in all, 10 DP columns, 11
// block 0 in all in ns (%globaltimer), 12-13 block 0's start and end
// (%globaltimer, ns)
__device__ long long mas_clocks[CLOCK_ROWS][CLOCKS];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct Clock {
  long long t, ns;
  __device__ void start() {
    t = clock64();
    ns = global_ns();
  }
  __device__ void wall(int b, int i) {
    if (b < CLOCK_ROWS) {
      const long long now = global_ns();
      mas_clocks[b][i] += now - ns;
      mas_clocks[b][12] = ns;
      mas_clocks[b][13] = now;
    }
  }
  __device__ void add(int b, int i) {
    const long long n = clock64();
    if (b < CLOCK_ROWS) atomicAdd(reinterpret_cast<unsigned long long*>(&mas_clocks[b][i]),
                                  (unsigned long long)(n - t));
    t = n;
  }
  __device__ void peak(int b, int i) {
    if (b < CLOCK_ROWS) atomicMax(&mas_clocks[b][i], clock64() - t);
  }
};
#else
struct Clock {
  __device__ void start() {}
  __device__ void add(int, int) {}
  __device__ void peak(int, int) {}
  __device__ void wall(int, int) {}
};
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// The arrival that also expects `bytes` from bulk copies on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
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
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) by the copy engine,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // acquire
}

// Zero p[0, n) with the block's threads, 16 bytes a store where aligned.
__device__ void zero_floats(float* p, size_t n) {
  const int t = threadIdx.x, nt = blockDim.x;
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  if (head > n) head = n;
  const size_t n4 = (n - head) / 4;
  for (size_t i = t; i < head; i += nt) p[i] = 0.f;
  float4* q = reinterpret_cast<float4*>(p + head);
  for (size_t i = t; i < n4; i += nt) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + t; i < n; i += nt) p[i] = 0.f;
}

template <int R>
__device__ __forceinline__ void load_scores(float (&v)[R], const float* src) {
#pragma unroll
  for (int k = 0; k < R; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}

// The decisions fd_y[x] for x in [base, base + 32) of a column's x-linear
// words, bit i for x = base + i, come with JAX's gather rule: x < 0 reads
// x + T_x, x < -T_x reads True (only scores summing under -1e9 along the
// text's first row take x below 0).
__device__ __forceinline__ uint32_t window_far(const uint32_t* col, int base, int t_x) {
  uint32_t w = 0;  // base < -31: a bit at a time
  for (int i = 0; i < 32; ++i) {
    const int x = base + i + t_x;
    w |= (x >= 0 ? (col[x >> 5] >> (x & 31)) & 1u : 1u) << i;
  }
  return w;
}

// A column's decisions at [base, base + 32), bit i for x = base + i (base
// the same in every lane, so the branches are the warp's).
__device__ __forceinline__ uint32_t window32(const uint32_t* col, int base, int words, int t_x) {
  if (base >= 0) {
    const int i = base >> 5;
    return __funnelshift_r(col[i], col[min(i + 1, words - 1)], base & 31);
  }
  if (base < -31) return window_far(col, base, t_x);
  const int s = t_x + base, i = max(s, 0) >> 5;  // x < 0 reads x + t_x (s for x = base)
  const uint32_t w0 = col[0], lo = col[i], hi = col[min(i + 1, words - 1)];
  const uint32_t wrapped =
      s >= 0 ? __funnelshift_r(lo, hi, s & 31) : (w0 << (-s)) | ((1u << (-s)) - 1u);
  return (w0 << (-base)) | (wrapped & ((1u << (-base)) - 1u));
}

// One x of a column: fd = diag > best (strict, false on NaN as JAX's),
// best = (fd ? diag : best) + v in one IEEE add, and the decision added to
// bits_f as 2^k on the FMA pipe (a predicated add) rather than packed by
// integer selects.
__device__ __forceinline__ void step(float& best, float diag, float v, float& bits_f,
                                     float bit) {
  asm("{\n"
      ".reg .pred p;\n"
      "setp.gt.f32 p, %2, %0;\n"
      "selp.f32 %0, %2, %0, p;\n"
      "add.rn.f32 %0, %0, %3;\n"
      "@p add.rn.f32 %1, %1, %4;\n"
      "}\n"
      : "+f"(best), "+f"(bits_f)
      : "f"(diag), "f"(v), "f"(bit));
}

// A DP warp's columns 1..yl-1 (PREV: x starts past warp 0, so its first diag
// comes from warp - 1's handoff words).
template <int R, bool PREV>
__device__ __forceinline__ void dp_warp(const Args a, int b, int xl, int yl, const float* ring,
                                        uint32_t* bits, unsigned long long* bnd, uint64_t* full,
                                        uint64_t* empty, Clock& clk) {
  const int W = a.warps, S = a.stages, C = a.cols, L = a.slots;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  asm volatile("" : "+r"(warp), "+r"(lane));  // kept in registers, not rederived in the loop
  const int txp = W * 32 * R, col_bytes = 4 * W * R;
  const int x0 = (warp * 32 + lane) * R;
  const bool publish = warp < W - 1 && lane == 31;
  const volatile unsigned long long* in = bnd + (size_t)(PREV ? warp - 1 : 0) * L;
  volatile unsigned long long* out = bnd + (size_t)warp * L;
  // this lane's decisions in a column
  uint8_t* my_bits = reinterpret_cast<uint8_t*>(bits) + (warp * 32 + lane) * (R / 8);
  float best[R];
  mbar_wait(&full[0], 0);
  const float v00 = ring[0];
#pragma unroll
  for (int k = 0; k < R; ++k) best[k] = x0 + k == 0 ? v00 : NEG_INF;
  // One column y on its scores v. The last x goes first: its value is the
  // next column's shuffle (issued here, used a column later) and warp + 1's
  // handoff word; the first x goes last, after warp - 1's word is read.
  float up_raw = __shfl_up_sync(FULL_MASK, best[R - 1], 1);
  auto column = [&](const float (&v)[R], int y) {
    // warp - 1's handoff word for this column, read first and checked last
    unsigned long long w = PREV ? in[(y - 1) & (L - 1)] : 0ull;
    float bits_f = 0.f;  // the decisions as a float, sum of 2^k where x0 + k comes from diag
    step(best[R - 1], best[R - 2], v[R - 1], bits_f, (float)(1 << (R - 1)));
    const float up_next = __shfl_up_sync(FULL_MASK, best[R - 1], 1);
    if (publish)
      out[y & (L - 1)] = (unsigned long long)y << 32 | __float_as_uint(best[R - 1]);
#pragma unroll
    for (int k = R - 2; k >= 1; --k) step(best[k], best[k - 1], v[k], bits_f, (float)(1 << k));
    float up = up_raw;
    if (PREV) {  // warp - 1's best_{y-1} at its last x (every lane reads the word)
      if ((uint32_t)(w >> 32) != (uint32_t)(y - 1)) {
        if (warp == W - 1 && lane == 0) clk.start();
        do {
          w = in[(y - 1) & (L - 1)];
        } while ((uint32_t)(w >> 32) != (uint32_t)(y - 1));
        if (warp == W - 1 && lane == 0) clk.add(b, 2);
      }
      up = lane == 0 ? __uint_as_float((uint32_t)w) : up;
    } else {
      up = lane == 0 ? NEG_INF : up;
    }
    step(best[0], up, v[0], bits_f, 1.f);
    up_raw = up_next;
    // the sum is an integer below 2^16: its bits are the low mantissa bits of 2^23 + sum
    const uint32_t fd_bits = __float_as_uint(__fadd_rn(bits_f, 8388608.f)) & 0xffffu;
    uint8_t* dst = my_bits + y * col_bytes;
    if (R == 8) {
      *dst = (uint8_t)fd_bits;
    } else {
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)fd_bits;
    }
  };
  Clock dp;
  dp.start();
  const int nchunks = (yl + C - 1) / C;
  for (int ch = 0, s = 0; ch < nchunks; ++ch) {
    if (ch > 0) {  // free the last stage, wait for this one
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == S) s = 0;
      if (warp == 0 && lane == 0) clk.start();
      mbar_wait(&full[s], (ch / S) & 1);
      if (warp == 0 && lane == 0) clk.add(b, 1);
    }
    // two score buffers: each column's scores load while the column before is computed
    const float* col = ring + s * C * txp + x0;
    const int y0 = ch * C, c_end = min(C, yl - y0);
    int c = ch == 0 ? 1 : 0;
    float va[R], vb[R];
    load_scores<R>(va, col + min(c, C - 1) * txp);
    for (; c + 1 < c_end; c += 2) {
      load_scores<R>(vb, col + (c + 1) * txp);
      column(va, y0 + c);
      load_scores<R>(va, col + min(c + 2, C - 1) * txp);
      column(vb, y0 + c + 1);
    }
    if (c < c_end) column(va, y0 + c);
  }
  if (lane == 0 && warp == 0) dp.add(b, 3);
  if (lane == 0 && warp == W - 1) dp.add(b, 4);
}

// A 1 at p where on (a predicated store, no branch).
__device__ __forceinline__ void store_one_if(float* p, bool on) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %0, 0;\n"
      "@q st.global.f32 [%1], 0f3F800000;\n"
      "}\n" ::"r"((int)on),
      "l"(p)
      : "memory");
}

template <int R, bool SHARED_BITS>
__global__ void __launch_bounds__(512) mas_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.cluster, rank = blockIdx.x % G, b = blockIdx.x / G;
  const int t_x = a.t_x, t_y = a.t_y;
  const int xl = min(max(a.x_len[b], 0), t_x), yl = min(max(a.y_len[b], 0), t_y);
  float* prow = a.path + (size_t)b * t_x * t_y;
  const size_t n_path = (size_t)t_x * t_y;
  Clock clk, total;
  clk.start();
  total.start();

  if (rank != 0) {  // a zeroing block: stripe rank - 1 of G - 1
    const size_t lo = n_path * (rank - 1) / (G - 1), hi = n_path * rank / (G - 1);
    zero_floats(prow + lo, hi - lo);
    __threadfence();
    clk.peak(b, 8);
    cluster_arrive();
    cluster_wait();
    return;
  }
  cluster_arrive();  // block 0's part of the one cluster barrier
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (xl == 0 || yl == 0) {
    if (G == 1) zero_floats(prow, n_path);
    cluster_wait();
    return;
  }

  const int W = a.warps, S = a.stages, C = a.cols, L = a.slots;
  const int txp = W * 32 * R;  // a ring column: every DP lane's positions
  const int words = W * R;     // a column's decision words
  const Layout lay = layout(R, W, S, C, L, t_y, SHARED_BITS);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  uint32_t* bits = SHARED_BITS ? reinterpret_cast<uint32_t*>(smem + lay.bits)
                               : a.gbits + (size_t)b * t_y * words;
  unsigned long long* bnd = reinterpret_cast<unsigned long long*>(smem + lay.bnd);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* empty = full + S;

  // -1e9 where no copy writes; the handoff words: column 0's -1e9, else no column
  for (int c = warp; c < S * C; c += blockDim.x >> 5)
    for (int x = xl + lane; x < txp; x += 32) ring[(size_t)c * txp + x] = NEG_INF;
  for (int i = tid; i < (W - 1) * L; i += blockDim.x)
    bnd[i] = i % L == 0 ? (unsigned long long)__float_as_uint(NEG_INF)
                        : 0xffffffff00000000ull;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 2);   // the copy warp's lane 0: with the bulk bytes, after the tails
      mbar_init(&empty[s], W);  // lane 0 of each DP warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) clk.add(b, 0);

  if (warp == W) {  // the copy warp
    const float* vrow = a.value + (size_t)b * t_y * t_x;
    const bool bulk = t_x % 4 == 0 && reinterpret_cast<uintptr_t>(a.value) % 16 == 0;
    const int n4 = bulk ? xl & ~3 : 0, tail = xl - n4;
    const int nchunks = (yl + C - 1) / C;
    // lane c holds the up to 3 scores of column c of the next chunk past its
    // bulk copy, loaded a chunk ahead
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
    auto load_tail = [&](int k) {
      const int y = k * C + lane;
      if (lane < C && y < yl) {
        const float* p = vrow + (size_t)y * t_x + n4;
        if (tail > 0) t0 = __ldg(p);
        if (tail > 1) t1 = __ldg(p + 1);
        if (tail > 2) t2 = __ldg(p + 2);
      }
    };
    if (bulk) load_tail(0);
    for (int k = 0; k < nchunks; ++k) {
      const int s = k % S;
      if (k >= S) mbar_wait(&empty[s], ((k / S) - 1) & 1);
      const int y0 = k * C, nc = min(C, yl - y0);
      float* dst = ring + (size_t)s * C * txp;
      const float* src = vrow + (size_t)y0 * t_x;
      if (lane == 0) {
        if (n4 > 0)
          mbar_expect(&full[s], (uint32_t)(nc * n4 * 4));
        else
          mbar_arrive(&full[s]);
      }
      __syncwarp();
      if (bulk) {
        if (n4 > 0 && lane < nc)
          bulk_copy(dst + (size_t)lane * txp, src + (size_t)lane * t_x, n4 * 4, &full[s]);
        if (lane < nc) {
          float* d = dst + (size_t)lane * txp + n4;
          if (tail > 0) d[0] = t0;
          if (tail > 1) d[1] = t1;
          if (tail > 2) d[2] = t2;
        }
        if (k + 1 < nchunks) load_tail(k + 1);
      } else {  // T_x % 4 != 0: the threads copy (no 16-byte aligned rows for the copy engine)
        for (int c = 0; c < nc; ++c)
          for (int x = lane; x < xl; x += 32)
            dst[(size_t)c * txp + x] = __ldg(src + (size_t)c * t_x + x);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
  } else if (warp < W) {  // a DP warp
    if (warp > 0)
      dp_warp<R, true>(a, b, xl, yl, ring, bits, bnd, full, empty, clk);
    else
      dp_warp<R, false>(a, b, xl, yl, ring, bits, bnd, full, empty, clk);
  }
  clk.start();
  __syncthreads();  // every column's decisions are in
  if (tid == 0) clk.add(b, 5);
  if (G == 1) {
    zero_floats(prow, n_path);
    __syncthreads();
  }
  if (warp != 0) {
    cluster_wait();
    return;
  }

  cluster_wait();  // the zeroing blocks are done
  if (lane == 0) clk.add(b, 6);
  // The backtrack, by warp 0, WINDOW columns at a time: lane j holds column
  // ytop - j's decisions at [base, base + 32), base 31 below the x at the
  // start of the window before (x falls by at most 1 a column, so it stays
  // inside), loaded a window ahead. Shuffles give every lane the window's
  // words; every lane walks them, two columns a step (column j's bit b1 at
  // off, column j + 1's bits at off and off - 1, then the one b1 picks); lane
  // j stores column ytop - j's 1, its x the window's first less the falls
  // before it.
  int x = xl - 1;
  auto load = [&](int ytop, int base) -> uint32_t {
    const int y = ytop - lane;
    return lane < WINDOW && y >= 1 ? window32(bits + (size_t)y * words, base, words, t_x) : 0u;
  };
  auto spread = [&](uint32_t (&w)[WINDOW], uint32_t mine) {
#pragma unroll
    for (int j = 0; j < WINDOW; ++j) w[j] = __shfl_sync(FULL_MASK, mine, j);
  };
  auto walk = [&](const uint32_t (&w)[WINDOW], int base, int ytop) {
    uint32_t falls = 0;  // bit j: x falls at column ytop - j
    int off = x - base;
#pragma unroll
    for (int j = 0; j < WINDOW; j += 2) {
      const uint32_t b1 = (w[j] >> off) & 1u;
      const uint32_t c0 = (w[j + 1] >> off) & 1u, c1 = ((w[j + 1] << 1) >> off) & 1u;
      const uint32_t c = c0 ^ ((c0 ^ c1) & b1);
      falls |= b1 << j | c << (j + 1);
      off -= (int)(b1 + c);
    }
    const int y = ytop - lane, xx = x - __popc(falls & ((1u << lane) - 1u));
    store_one_if(prow + (unsigned)(xx * t_y + y), lane < WINDOW && (y | xx) >= 0);
    x = base + off;
  };
  // two windows in turn: one walked while the next one's words load, then
  // spread to every lane before its walk
  int ytop = yl - 1, base_a = x - 31, base_b;
  uint32_t wa[WINDOW], wb[WINDOW];
  spread(wa, load(ytop, base_a));
  while (true) {
    base_b = x - 31;
    const uint32_t mine_b = load(ytop - WINDOW, base_b);
    walk(wa, base_a, ytop);
    if ((ytop -= WINDOW) < 0) break;
    spread(wb, mine_b);
    base_a = x - 31;
    const uint32_t mine_a = load(ytop - WINDOW, base_a);
    walk(wb, base_b, ytop);
    if ((ytop -= WINDOW) < 0) break;
    spread(wa, mine_a);
  }
  if (lane != 0) return;
  clk.add(b, 7);
  total.add(b, 9);
  total.wall(b, 11);
#ifdef MAS_CLOCKS
  if (b < CLOCK_ROWS) mas_clocks[b][10] += yl - 1;
#endif
}

bool valid(int R, int B, int t_y, int t_x, int warps, int stages, int cols, int cluster,
           int slots, int shared_bits) {
  if (B <= 0 || t_y <= 0 || t_x <= 0 || stages < 2 || cols < 1) return false;
  // a row's path and decisions indexed in 32 bits
  if ((long long)t_x * t_y >= (1LL << 31) || (long long)t_y * warps * R * 4 >= (1LL << 31))
    return false;
  if ((R != 8 && R != 16) || cols > 32) return false;
  if (warps < 1 || warps > MAX_DP_WARPS || (long long)warps * 32 * R < t_x ||
      (long long)(warps - 1) * 32 * R >= t_x)
    return false;
  if (cluster < 1 || cluster > MAX_CLUSTER) return false;
  if (warps > 1 && (slots <= stages * cols || (slots & (slots - 1)) != 0)) return false;
  return layout(R, warps, stages, cols, slots, t_y, shared_bits).total <= SMEM_LIMIT;
}

template <int R, bool SB>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = (int)layout(R, a.warps, a.stages, a.cols, a.slots, a.t_y, SB).total;
  cudaError_t err = cudaFuncSetAttribute(mas_kernel<R, SB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * max(a.warps + 1, MIN_WARPS)), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mas_kernel<R, SB>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of a plan (ops/monotonic_align.py:plan computes the
// same), or -1 where the plan does not fit the kernel.
extern "C" long long monotonic_align_smem(int t_y, int t_x, int R, int warps, int stages,
                                          int cols, int slots, int shared_bits) {
  if (!valid(R, 1, t_y, t_x, warps, stages, cols, 1, slots, shared_bits)) return -1;
  return layout(R, warps, stages, cols, slots, t_y, shared_bits).total;
}

// One launch on the plan (R positions a lane, DP warps, ring stages x
// columns, blocks a row, handoff words, decisions in shared memory or in
// global_bits = [B, T_y, warps * R] int32).
extern "C" int monotonic_align(const void* value, const void* x_len, const void* y_len,
                               void* path, void* global_bits, int B, int t_y, int t_x, int R,
                               int warps, int stages, int cols, int cluster, int slots,
                               int shared_bits, void* stream) {
  if (!valid(R, B, t_y, t_x, warps, stages, cols, cluster, slots, shared_bits))
    return (int)cudaErrorInvalidValue;
  if (!shared_bits && global_bits == nullptr) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(value), static_cast<const int*>(x_len),
         static_cast<const int*>(y_len), static_cast<float*>(path),
         static_cast<uint32_t*>(global_bits), t_y, t_x, warps, stages, cols, cluster, slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 8) return (int)(shared_bits ? launch<8, true>(a, B, s) : launch<8, false>(a, B, s));
  return (int)(shared_bits ? launch<16, true>(a, B, s) : launch<16, false>(a, B, s));
}

#ifdef MAS_CLOCKS
// Copy rows x 14 counters of mas_clocks to `out` (host memory) and clear them.
extern "C" int monotonic_align_clocks(long long* out, int rows) {
  if (rows > CLOCK_ROWS) rows = CLOCK_ROWS;
  cudaError_t err = cudaMemcpyFromSymbol(out, mas_clocks, sizeof(long long) * CLOCKS * rows);
  if (err != cudaSuccess) return (int)err;
  static long long zeros[CLOCK_ROWS][CLOCKS];
  return (int)cudaMemcpyToSymbol(mas_clocks, zeros, sizeof(zeros));
}
#endif
