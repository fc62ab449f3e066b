// The dynamic W8A8 int8 convolution of the quantized decoder, on Hopper's
// int8 tensor cores (sm_90a): Q1 `int8_conv1d` and Q2 `row_absmax`.
//
// No Pallas kernel stands behind these two: the JAX package runs its int8
// decoder convolution as an XLA conv_general_dilated of int8 operands with
// int32 accumulation (vcvits_tpu/ops/int8_conv.py:int8_conv1d), and PyTorch
// has no int8 convolution on CUDA. The function (ops/int8_conv.py holds the
// plain version, and the order of its float operations is part of it):
//   act(x)      = x, or leaky_relu(x, slope) rounded to x's type
//   a_scale[b]  = max(max |act(x[b])| over all T and C, 1e-12) / 127
//   xq          = clip(rint(float(act(x)) / a_scale[b]), -127, 127)    (IEEE divide)
//   acc[b,t,o]  = sum over taps j and inputs i of xq[b, t - pad_lo + j*dil, i] * w[j, o, i]
//                 (rows outside [0, T) are 0), exact in int32
//   y[b,t,o]    = float(acc) * (a_scale[b] * w_scale[o]) + bias[o], in float32
//                 (no contraction into an FMA), then rounded to x's type
// and then, each step where asked and rounded to x's type, as the decoder's
// module path computes them around the conv (models/hifigan.py):
//   y = y + r[b, t, o]   the residual (a ResBlock's `c2(...) + x`), or
//                        r[b, o], the speaker term after conv_pre
//   y = s[b, t, o] + y   the sum of the MRF's blocks so far
//   y = y / divisor      the blocks' mean (an IEEE division)
//   emit[b] = max(emit[b], max |act'(y[b])|)   the row maximum the next conv
//                        quantizes with, act' that conv's activation
// w (int8 codes) and w_scale come quantized per output column from the
// wrapper, which caches them; a transposed conv arrives phase-decomposed,
// its columns (phase, channel) each with its own scale.
//
// What bounds it. One 10 s request at 48 kHz (configs/48k_base.json) makes
// 78 convs; the MRF is 126 C^2 T multiply-adds a stage, about 383 G in all:
// 0.39 ms at the int8 rate of 1,979 TOP/s. A conv reads its input and
// writes its output once (3.8 to 30.7 MB a stage's activation in bf16,
// twice that in fp32), and the ResBlock convs also read their residual and
// the blocks' partial sums, so the request is bound by bytes (about 2.4 ms
// in fp32, 1.2 in bf16). The first design quantized each input element
// again for every 64-column tile (up to 32 times) with an IEEE division
// each, synchronised twice a tap, padded Co = 32 to 64 columns and stored
// scalars a thread at a time: it ran at 0.11-0.21 of the bound, as fast in
// bf16 as in fp32. Clock counters in the kernel showed where a block's time
// went: not to waiting on memory but to issuing instructions, phase after
// phase, at a low rate. This design cuts instructions and keeps the copies
// off the threads:
//
// * Persistent blocks: `plan` gives a column group about two blocks an SM,
//   and each walks (row, frame tile) pairs, so a block loads its weights
//   once. Where the whole kernel of its column tiles fits beside the tile
//   (stages 2 and 3, conv_post, the small taps of stage 1) it stays
//   resident: one load and no barrier a tap. Elsewhere the (column tile,
//   tap) chunks stream through a ring of 2 or 3 cp.async stages, one
//   barrier a chunk.
// * Input by the copy engine: where two blocks an SM still fit, the next
//   pair's input rows (halo included) arrive in shared memory by one bulk
//   copy (TMA, cp.async.bulk on an mbarrier) while this pair is multiplied;
//   elsewhere the threads load them, four 16-byte loads in flight each.
// * Quantized once a launch where the grid allows: a block quantizes its
//   frames once and covers `nt` column tiles from them (the upsamplers and
//   stages 0-1: 2-16 tiles, where the first design quantized again for
//   each of up to 32).
// * A quantizer without a division or conversion on the common path:
//   p = v * (1 / scale), clamped, rounded half to even by adding 1.5 * 2^23,
//   the code the low byte of the sum. Only where one of four products lies
//   within 2^-14 of a half-integer (a few ulps cover the product's error)
//   do the four take rint(__fdiv_rn(v, scale)), so the codes stay those of
//   the IEEE quotient bit for bit.
// * Tiles sized to the shape: 128 frames x 64 columns, 64 x 64 where a
//   launch has few frames, 256 x 32 at Co <= 32 and 256 x 8 for conv_post's
//   one column, so no tensor-core column is padding at Co = 32. Fragments
//   load by ldmatrix and multiply on mma.sync m16n8k32 s8 x s8 -> s32; the
//   products are about a fifth of the time (the `nomma` ablation), so
//   wgmma is later work.
// * The epilogue from the accumulators, no staging: each thread's pairs of
//   neighbouring columns dequantized, two lanes swapping a pair so each
//   holds four neighbouring columns (16-byte stores), the residual and
//   partial sum of 16 rows loaded before any is used, and the row maximum
//   kept as the largest and least value stored (act' is monotone for a
//   slope >= 0, so max |act'(y)| is at one of them), one atomicMax a block
//   and row. The residual adds, the block sums, the mean and the next
//   conv's row maximum cost no launch and no pass of their own.
//
// Q2 reduces one row's max |act(x)| per thread-block cluster: up to 8
// blocks stream the row with 16-byte loads, block 0 gathers their maxima
// through distributed shared memory and stores the row's maximum, and the
// same launch zeroes the row's column of the decode's other slots, which
// the Q1 launches then fill with atomicMax (non-negative floats order as
// their bits do). A decode runs Q2 once, on conv_pre's input; every later
// conv's maximum comes from the epilogue of the conv that made its input.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CI = 512, MAX_CO = 4096, MAX_HALO = 64;
constexpr int MAX_SMEM = 232448;
constexpr int TWO_BLOCKS_SMEM = 113 * 1024;  // shared memory that leaves room for two blocks an SM
constexpr int ROW_PAD = 16;     // bytes after each shared-memory row of codes
constexpr int SMS = 132;            // an H100's SMs
constexpr long long SM_SMEM = 233472;  // shared memory an SM has for its blocks
constexpr int TARGET_BLOCKS = 2 * SMS;  // frame tiles x column groups to aim for
constexpr int FEW_FRAMES_BLOCKS = SMS;
constexpr float TIE_TOL = 1.f / 16384.f;
constexpr int Q2_THREADS = 512, Q2_MAX_CLUSTER = 8, Q2_BYTES_A_BLOCK = 32768;

// The tiles: output frames and columns a block, warps along each.
struct Tile {
  int bm, bn, wm, wn;
};
constexpr Tile TILES[4] = {{128, 64, 4, 2}, {256, 32, 8, 1}, {256, 8, 8, 1}, {64, 64, 2, 2}};

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One Q1 launch's shape. ops/int8_conv.py:plan mirrors `plan`.
struct Plan {
  int tile;      // index into TILES
  int nt;        // column tiles a block covers from one quantized input tile
  int groups;    // blocks along the columns
  int ring;      // weight chunks (column tile, tap) held at once; nt * K: resident
  int prefetch;  // 1: the next frame tile's input is copied into shared memory (cp.async)
                 // while this one is multiplied
  int persist;   // blocks a column group: each walks the (row, frame tile) pairs
  int smem;      // dynamic shared-memory bytes
  int ci_pad, span, xs_bytes;
};

bool plan(int Ci, int Co, int K, int dil, int Tout, int B, int bf16, Plan* p) {
  if (Ci < 1 || Ci > MAX_CI || Co < 1 || Co > MAX_CO || K < 1 || dil < 1 ||
      (K - 1) * dil > MAX_HALO || Tout < 1 || B < 1 || B > 65535)
    return false;
  int tile = 0;
  if (Co <= 8)
    tile = 2;
  else if (Co <= 32)
    tile = 1;
  else if ((long long)cdiv(Tout, 128) * B < FEW_FRAMES_BLOCKS)
    tile = 3;
  const Tile& t = TILES[tile];
  const int ci_pad = round_up(Ci, 32), rb = ci_pad + ROW_PAD, es = bf16 ? 2 : 4;
  const int n_tiles = cdiv(Co, t.bn);
  const long long items = (long long)cdiv(Tout, t.bm) * B;
  int groups = (int)((TARGET_BLOCKS + items - 1) / items);
  if (groups > n_tiles) groups = n_tiles;
  const int nt = cdiv(n_tiles, groups);
  groups = cdiv(n_tiles, nt);
  const int span = t.bm + (K - 1) * dil;
  const int xs_bytes = round_up(span * rb, 16);
  const int chunk = t.bn * rb;
  const int fixed = xs_bytes;
  int ring = nt * K;
  if (fixed + ring * chunk > TWO_BLOCKS_SMEM) ring = fixed + 3 * chunk <= TWO_BLOCKS_SMEM ? 3 : 2;
  if (ring > nt * K) ring = nt * K;
  long long smem = (long long)fixed + (long long)ring * chunk;
  const long long raw = round_up(span * Ci * es, 16);
  const int prefetch = ring == nt * K && Ci * es % 16 == 0 && smem + raw <= TWO_BLOCKS_SMEM;
  if (prefetch) smem += raw;
  if (smem > MAX_SMEM) return false;
  const int per_sm = (int)(SM_SMEM / (smem + 1024)) >= 2 ? 2 : 1;
  long long persist = ((long long)SMS * per_sm + groups - 1) / groups;
  if (persist > items) persist = items;
  *p = Plan{tile, nt, groups, ring, prefetch, (int)persist, (int)smem, ci_pad, span, xs_bytes};
  return true;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// The one arrival on `bar` for its current phase, expecting `bytes` from copies.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory by
// the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Values of the input's type, held as floats: round, load, store.
__device__ __forceinline__ float rnd(float v, float*) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The rare and the once-a-stage divisions, out of line: the hot loops stay
// small enough for the instruction cache.
__device__ __noinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(uint4 u, float* f, float*) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y), f[2] = __uint_as_float(u.z),
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* f, __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// Two neighbouring values of T as floats, and back
__device__ __forceinline__ void load2(const float* p, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x, f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  f[0] = __low2float(v), f[1] = __high2float(v);
}
__device__ __forceinline__ void store2(float* p, const float* f) {
  *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* f) {  // f: bf16 values
  *reinterpret_cast<uint32_t*>(p) = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
}

// Four neighbouring values of T as floats, and back (16 bytes, bf16 8)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  load2(p, f);
  load2(p + 2, f + 2);
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {  // f: bf16 values
  *reinterpret_cast<uint2*>(p) =
      make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                 __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// The activation in the type T, of a value of T held as a float: torch's
// leaky_relu (x > 0 ? x : x * slope, the product in float32, rounded once).
template <typename T>
__device__ __forceinline__ float act(float v, float slope, bool on) {
  return on && !(v > 0.f) ? rnd(__fmul_rn(v, slope), (T*)nullptr) : v;
}

// Four codes rint(v / scale) clipped to +-127 (round half to even, as
// jnp.round), packed in a word, from the products with rcp = 1 / scale:
// their error is a few ulps of |q| < 128, so only a product within
// TIE_TOL of a half-integer can round otherwise than the IEEE quotient,
// and where one of the four is, all four take the quotient. Adding
// MAGIC = 1.5 * 2^23 rounds |x| < 2^22 to an integer, half to even, on the
// float pipe; the code is then the low byte of the sum's bits.
__device__ __forceinline__ uint32_t quant4(const float* v, float scale, float rcp) {
  constexpr float MAGIC = 12582912.f;
  float sum[4], near = 1.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float pc = fminf(fmaxf(__fmul_rn(v[e], rcp), -127.f), 127.f);
    sum[e] = __fadd_rn(pc, MAGIC);
    near = fminf(near, fabsf(fabsf(__fsub_rn(pc, __fsub_rn(sum[e], MAGIC))) - 0.5f));
  }
  if (near < TIE_TOL) {
    for (int e = 0; e < 4; ++e)
      sum[e] = __fadd_rn(fminf(fmaxf(rintf(div_rn(v[e], scale)), -127.f), 127.f), MAGIC);
  }
  const uint32_t lo = __byte_perm(__float_as_uint(sum[0]), __float_as_uint(sum[1]), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(sum[2]), __float_as_uint(sum[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

}  // namespace

// Q1's arguments (bound with ctypes as ops/int8_conv.py:_Q1Args). Device
// pointers; x, y, res and acc are of one type (float32, or bfloat16 where
// bf16 == 1), contiguous:
//   x: [B, T, Ci];  y: [B, Tout, Co]
//   w: int8 [K, co_pad = round_up(Co, 64), round_up(Ci, 32)] codes as (tap,
//      out, in), zero where padded, 16-byte aligned
//   w_scale: float32 [Co]; bias: float32 [Co] or null
//   amax: float32 [B], the rows' max |act(x)| (from Q2 or a Q1's emit)
//   res: null, or the residual r[b * res_bstride + t * res_tstride + o]
//        (res_tstride 0: a per-row term)
//   acc: null, or the partial sum [B, Tout, Co]
//   emit: null, or float32 [B] that receives max |act'(y)| by atomicMax,
//        act' the leaky ReLU of emit_slope where emit_has_slope
// Output frame t reads input frames t - pad_lo + j*dil, j < K; the
// activation of x is leaky_relu(slope) where has_slope. y = y / divisor
// where has_div.
struct Q1Args {
  const void* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  const float* amax;
  void* y;
  const void* res;
  const void* acc;
  float* emit;
  long long res_bstride, res_tstride;
  int B, T, Ci, Co, co_pad, K, dil, pad_lo, Tout;
  float slope, emit_slope, divisor;
  int has_slope, emit_has_slope, has_div, bf16;
};

namespace {

struct Q1Params {
  Q1Args a;
  Plan p;
  int n_tiles, vec_in, vec_out, prefetch;
};

template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
    int8_conv_kernel(const __grid_constant__ Q1Params prm) {
  constexpr int THREADS = 32 * WM * WN, WC = BN / WN, NI = WC / 8;
  constexpr int V = 16 / sizeof(T);  // values in 16 bytes
  static_assert(BM == 32 * WM && (NI == 1 || NI % 2 == 0), "a warp is 32 frames by 8k columns");
  const Q1Args& a = prm.a;
  const Plan& p = prm.p;
  extern __shared__ __align__(16) int8_t smem[];
  const int rb = p.ci_pad + ROW_PAD;
  int8_t* xs = smem;                    // [span][rb]: the quantized input tile
  int8_t* wring = smem + p.xs_bytes;    // [ring][BN][rb]: weight chunks
  T* raw = reinterpret_cast<T*>(wring + p.ring * BN * rb);  // [span][Ci]: the next tile's input
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int tile0 = blockIdx.x * p.nt;
  const int n_here = min(p.nt, prm.n_tiles - tile0);
  const int K = a.K, chunks = n_here * K;
  const bool resident = p.ring >= p.nt * K, prefetch = prm.prefetch != 0;
  const int n_ft = cdiv(a.Tout, BM), items = n_ft * a.B;
  int item = blockIdx.y;  // this block's (row, frame tile) pairs: item, item + gridDim.y, ...

  // Calls f(r, c) for each cell of a rows x per grid, this thread's share:
  // where per divides THREADS (every decoder width) the thread keeps one
  // column and strides over the rows, so the loop does no division.
  auto grid_for = [&](int rows, int per, auto f) {
    if (THREADS % per == 0) {
      const int step = THREADS / per, c = tid % per;
      for (int r = tid / per; r < rows; r += step) f(r, c);
    } else {
      for (int i = tid; i < rows * per; i += THREADS) {
        const int r = i / per;
        f(r, i - r * per);
      }
    }
  };
  auto load_chunk = [&](int c, int slot) {
    const int n = tile0 + c / K, tap = c % K;
    const int8_t* src = a.w + ((size_t)tap * a.co_pad + (size_t)n * BN) * p.ci_pad;
    int8_t* dst = wring + slot * BN * rb;
    grid_for(BN, p.ci_pad / 16, [&](int r, int c16) {
      cp_async16(dst + r * rb + c16 * 16, src + (size_t)r * p.ci_pad + c16 * 16);
    });
  };
  // the input rows of a frame tile that lie in [0, T), halo included, as they
  // are: one contiguous bulk copy by the copy engine (TMA), completing on raw_bar
  __shared__ __align__(8) uint64_t raw_bar;
  uint32_t raw_phase = 0;
  auto load_raw = [&](int it) {  // thread 0
    const int bb = it / n_ft, row0 = (it - bb * n_ft) * BM - a.pad_lo;
    const int lo = max(row0, 0), hi = min(row0 + p.span, a.T);
    const uint32_t bytes = (uint32_t)(hi - lo) * a.Ci * sizeof(T);
    bulk_expect(&raw_bar, bytes);
    bulk_copy(raw + (lo - row0) * a.Ci, static_cast<const T*>(a.x) + ((size_t)bb * a.T + lo) * a.Ci,
              bytes, &raw_bar);
  };
  if (prefetch && tid == 0) {
    mbar_init(&raw_bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_raw(item);
  }
  if (resident) {
    for (int c = 0; c < chunks; ++c) load_chunk(c, c);
    cp_commit();
  }

  const bool slope_on = a.has_slope != 0;
  const float slope = a.slope;
  const int r_w = (warp % WM) * 32, c_w = (warp / WM) * WC;
  const bool emit_on = a.emit != nullptr, emit_slope_on = a.emit_has_slope != 0;
  const float emit_slope = a.emit_slope;
  // the largest and least value this thread stored for the current row (0
  // included): act' is monotone (slope >= 0), so max |act'(y)| is at one of them
  float y_hi = 0.f, y_lo = 0.f;
  int acc[2][NI][4];
  const uint32_t a_lane = (lane & 15) * rb + (lane >> 4) * 16;
  const uint32_t b_lane = (c_w + (lane >> 4) * 8 + (lane & 7)) * rb + ((lane >> 3) & 1) * 16;

  for (bool first = true; item < items; item += gridDim.y, first = false) {
    const int b = item / n_ft, t0 = (item - b * n_ft) * BM, row0 = t0 - a.pad_lo;
    const float a_scale = __fdiv_rn(fmaxf(a.amax[b], 1e-12f), 127.f);
    const float a_rcp = __fdiv_rn(1.f, a_scale);
    const T* xb = static_cast<const T*>(a.x) + (size_t)b * a.T * a.Ci;

    // quantize the tile's input frames, halo included, once for all its column tiles:
    // U groups of V values a thread at a time, their loads issued together
    auto quantize = [&](auto load) {
      constexpr int U = 4;
      const int groups = p.ci_pad / V;
      auto one = [&](int r, int c, uint4 u) {
        float f[V];
        unpack(u, f, (T*)nullptr);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = act<T>(f[e], slope, slope_on);
        if (V == 4)
          *reinterpret_cast<uint32_t*>(xs + r * rb + c) = quant4(f, a_scale, a_rcp);
        else
          *reinterpret_cast<uint2*>(xs + r * rb + c) =
              make_uint2(quant4(f, a_scale, a_rcp), quant4(f + 4, a_scale, a_rcp));
      };
      auto get = [&](int r, int c) {
        const int t = row0 + r;
        return t >= 0 && t < a.T && c < a.Ci ? load(r, c, t) : make_uint4(0u, 0u, 0u, 0u);
      };
      if (THREADS % groups == 0) {  // a column a thread, U rows at a time
        const int step = THREADS / groups, c = (tid % groups) * V;
        int r = tid / groups;
        for (; r + (U - 1) * step < p.span; r += U * step) {
          uint4 u[U];
#pragma unroll
          for (int j = 0; j < U; ++j) u[j] = get(r + j * step, c);
#pragma unroll
          for (int j = 0; j < U; ++j) one(r + j * step, c, u[j]);
        }
        for (; r < p.span; r += step) one(r, c, get(r, c));
      } else {
        for (int i = tid; i < p.span * groups; i += THREADS) {
          const int r = i / groups, c = (i - r * groups) * V;
          one(r, c, get(r, c));
        }
      }
    };
    if (prefetch) {  // from the copy in shared memory
      if (first) cp_wait<0>();  // the weights
      __syncthreads();  // every warp is done with the last tile's codes; raw_bar is set up
      mbar_wait(&raw_bar, raw_phase);
      raw_phase ^= 1;
      quantize([&](int r, int c, int) {
        return *reinterpret_cast<const uint4*>(raw + r * a.Ci + c);
      });
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // reads before the next copy
      __syncthreads();  // the codes are in; the copy is free
      if (tid == 0 && item + (int)gridDim.y < items) load_raw(item + gridDim.y);
    } else {
      __syncthreads();  // every warp is done with the last tile's codes and weights
      if (!resident) {
        for (int c = 0; c < p.ring - 1; ++c) {
          if (c < chunks) load_chunk(c, c);
          cp_commit();
        }
      }
      if (prm.vec_in) {  // Ci % V == 0 and x 16-byte aligned: V values a load
        quantize([&](int, int c, int t) {
          return __ldg(reinterpret_cast<const uint4*>(xb + (size_t)t * a.Ci + c));
        });
      } else {
        const int groups = p.ci_pad / 4;
        for (int i = tid; i < p.span * groups; i += THREADS) {
          const int r = i / groups, c = (i - r * groups) * 4, t = row0 + r;
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          if (t >= 0 && t < a.T)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < a.Ci) f[e] = act<T>(to_f(xb[(size_t)t * a.Ci + c + e]), slope, slope_on);
          *reinterpret_cast<uint32_t*>(xs + r * rb + c) = quant4(f, a_scale, a_rcp);
        }
      }
      if (resident) {
        if (first) cp_wait<0>();
        __syncthreads();  // the codes (and, the first time, the weights) are in
      }
    }

    T* yb = static_cast<T*>(a.y) + (size_t)b * a.Tout * a.Co;
    const T* accb = a.acc != nullptr ? static_cast<const T*>(a.acc) + (size_t)b * a.Tout * a.Co
                                     : nullptr;
    const T* resb = a.res != nullptr ? static_cast<const T*>(a.res) + b * a.res_bstride : nullptr;

    // y from its dequantized value: the residual, the sum, the mean, each
    // rounded to T; its |act'| folded into m
    auto finish = [&](float y, float r, float s) -> float {
      if (resb != nullptr) y = rnd(__fadd_rn(y, r), (T*)nullptr);
      if (accb != nullptr) y = rnd(__fadd_rn(s, y), (T*)nullptr);
      if (a.has_div) y = rnd(div_rn(y, a.divisor), (T*)nullptr);
      if (emit_on) y_hi = fmaxf(y_hi, y), y_lo = fminf(y_lo, y);
      return y;
    };

    // From the accumulators, four neighbouring columns a lane: a lane holds
    // columns 2q, 2q + 1 of each 8-column block; lanes q and q ^ 1 swap one
    // pair, so an even lane holds 4 columns of an even block and an odd lane
    // of an odd one. Half the stores of pairs, each 16 (bf16: 8) bytes.
    auto quads = [&](int n0, const float (*sc)[2], const float (*bs)[2]) {
      const bool odd = q & 1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        constexpr int NQ = NI / 2 > 0 ? NI / 2 : 1;  // (unused where NI is 1)
        float rq[2][NQ][4] = {}, sq[2][NQ][4] = {};
        if (resb != nullptr || accb != nullptr) {  // loaded before any is used
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + r_w + mi * 16 + g + 8 * h;
#pragma unroll
            for (int np = 0; np < NI / 2; ++np) {
              const int o = n0 + (2 * np + odd) * 8 + 2 * (q & 2);
              if (t >= a.Tout) continue;
              if (resb != nullptr) load4(resb + t * a.res_tstride + o, rq[h][np]);
              if (accb != nullptr) load4(accb + (size_t)t * a.Co + o, sq[h][np]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r_w + mi * 16 + g + 8 * h;
#pragma unroll
          for (int np = 0; np < NI / 2; ++np) {
            float v[2][2];
#pragma unroll
            for (int k = 0; k < 2; ++k)
#pragma unroll
              for (int e = 0; e < 2; ++e) {  // float(acc) * (a_scale * w_scale) + bias
                const int ni = 2 * np + k;
                v[k][e] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), sc[ni][e]);
                if (a.bias != nullptr) v[k][e] = __fadd_rn(v[k][e], bs[ni][e]);
                v[k][e] = rnd(v[k][e], (T*)nullptr);
              }
            const float s0 = odd ? v[0][0] : v[1][0], s1 = odd ? v[0][1] : v[1][1];
            const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            float y[4];
            if (odd)
              y[0] = r0, y[1] = r1, y[2] = v[1][0], y[3] = v[1][1];
            else
              y[0] = v[0][0], y[1] = v[0][1], y[2] = r0, y[3] = r1;
            if (t >= a.Tout) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = finish(y[e], rq[h][np][e], sq[h][np][e]);
            store4(yb + (size_t)t * a.Co + n0 + (2 * np + odd) * 8 + 2 * (q & 2), y);
          }
        }
      }
    };

    // from the accumulators: each thread's pairs of neighbouring columns
    auto epilogue = [&](int n) {
      const int n0 = n * BN + c_w;  // the warp's first column
      float sc[NI][2], bs[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + ni * 8 + q * 2 + e;
          sc[ni][e] = o < a.Co ? __fmul_rn(a_scale, a.w_scale[o]) : 0.f;
          bs[ni][e] = o < a.Co && a.bias != nullptr ? a.bias[o] : 0.f;
        }
      if constexpr (NI % 2 == 0) {
        if (prm.vec_out == 2) {  // whole column tiles: four neighbouring columns a lane
          quads(n0, sc, bs);
          return;
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // the residual and partial-sum pairs of these 16 rows, loaded before any is used
        float rp[2][NI][2] = {}, sp[2][NI][2] = {};
        if (prm.vec_out && (resb != nullptr || accb != nullptr)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + r_w + mi * 16 + g + 8 * h;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const int o = n0 + ni * 8 + q * 2;
              if (t >= a.Tout || o >= a.Co) continue;
              if (resb != nullptr) load2(resb + t * a.res_tstride + o, rp[h][ni]);
              if (accb != nullptr) load2(accb + (size_t)t * a.Co + o, sp[h][ni]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r_w + mi * 16 + g + 8 * h;
          if (t >= a.Tout) continue;
          T* yr = yb + (size_t)t * a.Co;
          const T* rr = resb != nullptr ? resb + t * a.res_tstride : nullptr;
          const T* sr = accb != nullptr ? accb + (size_t)t * a.Co : nullptr;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int o = n0 + ni * 8 + q * 2;
            if (o >= a.Co) continue;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // float(acc) * (a_scale * w_scale) + bias
              v[e] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), sc[ni][e]);
              if (a.bias != nullptr) v[e] = __fadd_rn(v[e], bs[ni][e]);
              v[e] = rnd(v[e], (T*)nullptr);
            }
            if (prm.vec_out) {  // Co even: whole pairs
#pragma unroll
              for (int e = 0; e < 2; ++e) v[e] = finish(v[e], rp[h][ni][e], sp[h][ni][e]);
              store2(yr + o, v);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (o + e < a.Co)
                  yr[o + e] = from_f<T>(finish(v[e], rr != nullptr ? to_f(rr[o + e]) : 0.f,
                                               sr != nullptr ? to_f(sr[o + e]) : 0.f));
            }
          }
        }
      }
    };

    for (int c = 0, n = 0, tap = 0; c < chunks; ++c) {  // chunk c: column tile n, tap
      int slot = c;
      if (!resident) {
        if (p.ring == 2)
          cp_wait<0>();
        else
          cp_wait<1>();
        __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
        const int next = c + p.ring - 1;
        if (next < chunks) load_chunk(next, next % p.ring);
        cp_commit();
        slot = c % p.ring;
      }
      if (tap == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
      }
      const uint32_t xa = smem_addr(xs + (r_w + tap * a.dil) * rb) + a_lane;
      const uint32_t wb = smem_addr(wring + slot * BN * rb) + b_lane;
      for (int k0 = 0; k0 < p.ci_pad; k0 += 32) {
        uint32_t af[2][4], bf[NI][2];
        ldsm_x4(af[0], xa + k0);
        ldsm_x4(af[1], xa + 16 * rb + k0);
        if constexpr (NI == 1) {
          ldsm_x2(bf[0], wb + k0);
        } else {
#pragma unroll
          for (int np = 0; np < NI / 2; ++np) {
            uint32_t r4[4];
            ldsm_x4(r4, wb + np * 16 * rb + k0);
            bf[2 * np][0] = r4[0], bf[2 * np][1] = r4[1];
            bf[2 * np + 1][0] = r4[2], bf[2 * np + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
      if (tap == K - 1) {
        epilogue(tile0 + n);
        tap = 0, ++n;
      } else {
        ++tap;
      }
    }

    // one atomicMax a block and row: when the next pair is another row, or none is left
    const int next = item + gridDim.y;
    if (emit_on && (next >= items || next / n_ft != b)) {
      float m = fmaxf(fabsf(act<T>(y_hi, emit_slope, emit_slope_on)),
                      fabsf(act<T>(y_lo, emit_slope, emit_slope_on)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) red[warp] = m;
      __syncthreads();
      if (warp == 0) {
        m = lane < THREADS / 32 ? red[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) atomicMax(reinterpret_cast<unsigned*>(a.emit) + b, __float_as_uint(m));
      }
      y_hi = y_lo = 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Q2_THREADS)
    row_absmax_kernel(const T* __restrict__ x, float* __restrict__ slots, int B, long long n,
                      int n_slots, float slope, int has_slope, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nblk = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const T* row = x + (size_t)b * n;
  const bool slope_on = has_slope != 0;
  const long long stride = (long long)nblk * Q2_THREADS;
  float m = 0.f;
  if (vec) {
    constexpr int V = 16 / sizeof(T), U = 4;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    const long long nv = n / V;
    for (long long i0 = (long long)rank * Q2_THREADS + tid; i0 < nv; i0 += U * stride) {
      uint4 u[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const long long i = i0 + j * stride;
        u[j] = i < nv ? __ldg(rv + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const T* v = reinterpret_cast<const T*>(&u[j]);
#pragma unroll
        for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(act<T>(to_f(v[e]), slope, slope_on)));
      }
    }
  } else {
    for (long long i = (long long)rank * Q2_THREADS + tid; i < n; i += stride)
      m = fmaxf(m, fabsf(act<T>(to_f(row[i]), slope, slope_on)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[Q2_THREADS / 32];
  __shared__ float block_max;
  if ((tid & 31) == 0) part[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < Q2_THREADS / 32 ? part[tid] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) block_max = m;
  }
  // the row's other slots (the decode's later row maxima) start at 0
  for (int s = 1 + rank * Q2_THREADS + tid; s < n_slots; s += stride) slots[(size_t)s * B + b] = 0.f;
  cluster.sync();
  if (rank == 0 && tid < 32) {
    m = tid < nblk ? *cluster.map_shared_rank(&block_max, tid) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) slots[b] = m;
  }
  cluster.sync();  // no block leaves while block 0 may read its maximum
}

template <typename T>
cudaError_t launch_conv(const Q1Args& a, const Plan& p, cudaStream_t stream) {
  Q1Params prm{a, p, 0, 0, 0, 0};
  const Tile& t = TILES[p.tile];
  constexpr int V = 16 / sizeof(T);
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  prm.n_tiles = cdiv(a.Co, t.bn);
  prm.vec_in = a.Ci % V == 0 && al16(a.x);
  // 2: quads (Co a whole number of warp column tiles, 4-value aligned), 1: pairs, 0: scalars
  auto aligned = [](const void* ptr, int n) {
    return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % (n * sizeof(T)) == 0;
  };
  auto fits = [&](int n) {
    return a.Co % n == 0 && aligned(a.y, n) && aligned(a.res, n) && aligned(a.acc, n) &&
           a.res_bstride % n == 0 && a.res_tstride % n == 0;
  };
  prm.vec_out = a.Co % (t.bn / t.wn) == 0 && t.bn / t.wn % 16 == 0 && fits(4) ? 2 : fits(2);
  prm.prefetch = p.prefetch && prm.vec_in;
  const dim3 grid(p.groups, p.persist);
  void (*kern)(const Q1Params);
  switch (p.tile) {
    case 0: kern = int8_conv_kernel<T, 128, 64, 4, 2>; break;
    case 1: kern = int8_conv_kernel<T, 256, 32, 8, 1>; break;
    case 2: kern = int8_conv_kernel<T, 256, 8, 8, 1>; break;
    default: kern = int8_conv_kernel<T, 64, 64, 2, 2>; break;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 32 * t.wm * t.wn, p.smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_absmax(const void* x, float* slots, int B, long long n, int n_slots,
                          float slope, int has_slope, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = n % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long bytes = n * (long long)sizeof(T);
  long long nblk = (bytes + Q2_BYTES_A_BLOCK - 1) / Q2_BYTES_A_BLOCK;
  if (nblk > Q2_MAX_CLUSTER) nblk = Q2_MAX_CLUSTER;
  if (nblk < 1) nblk = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nblk, B, 1);
  cfg.blockDim = dim3(Q2_THREADS, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, row_absmax_kernel<T>, static_cast<const T*>(x),
                                       slots, B, n, n_slots, slope, has_slope, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Q1's launch shape for (Ci, Co, K, dil, Tout, B, bf16): out[0..6] = tile,
// column tiles a block, blocks along the columns, weight chunks held, the
// input prefetch, blocks a column group, dynamic shared-memory bytes.
// Returns 0, or cudaErrorInvalidValue where Q1 does not take the size.
extern "C" int int8_conv_plan(int Ci, int Co, int K, int dil, int Tout, int B, int bf16,
                              int* out) {
  Plan p;
  if (!plan(Ci, Co, K, dil, Tout, B, bf16, &p)) return (int)cudaErrorInvalidValue;
  const int v[7] = {p.tile, p.nt, p.groups, p.ring, p.prefetch, p.persist, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// Q1 (bound with ctypes): the conv of Q1Args on `stream`. Returns the
// cudaError_t of the launch.
extern "C" int int8_conv1d(const Q1Args* a, void* stream) {
  Plan p;
  if (a->T < 1 || a->pad_lo < 0 || a->pad_lo > (a->K - 1) * a->dil ||
      a->co_pad != round_up(a->Co, 64) ||
      !plan(a->Ci, a->Co, a->K, a->dil, a->Tout, a->B, a->bf16, &p) ||
      (long long)cdiv(a->Tout, TILES[p.tile].bm) * a->B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? launch_conv<__nv_bfloat16>(*a, p, s) : launch_conv<float>(*a, p, s));
}

// Q2 (bound with ctypes): slots[b] = max |act(x[b])| over the row's n
// values, and slots[s * B + b] = 0 for 0 < s < n_slots, in one launch (no
// memset before it). x: [B, n] float32 or bfloat16 (bf16 == 1),
// contiguous; slots: float32 [n_slots, B]. Returns the cudaError_t of the
// launch.
extern "C" int row_absmax(const void* x, float* slots, int B, long long n, int n_slots,
                          float slope, int has_slope, int bf16, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)launch_absmax<__nv_bfloat16>(x, slots, B, n, n_slots, slope, has_slope, s);
  return (int)launch_absmax<float>(x, slots, B, n, n_slots, slope, has_slope, s);
}
