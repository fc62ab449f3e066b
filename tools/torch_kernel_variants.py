#!/usr/bin/env python3
"""Compare builds of one of the port's CUDA kernels in one run on one GPU.

    python3 tools/torch_kernel_variants.py KERNEL [VARIANT ...]

KERNEL is `mrf` (K1, csrc/mrf.cu), `flow_coupling` (K2,
csrc/flow_coupling.cu), `int8_conv` (Q1 and Q2, csrc/int8_conv.cu) or
`monotonic_align` (M1, csrc/monotonic_align.cu). A VARIANT is `NAME` (the source as it is for
`base`, else the named edit of EDITS below), or `NAME=SPEC`, where SPEC is
`EDIT+EDIT+-DFLAG=1...` (named edits and nvcc flags) or `@path/to/src.cu
[nvcc flags]` for another source (say, the parent commit's, unpacked into
a git-ignored directory). The variants are built in parallel with the
port's nvcc flags into build/torch_kernels/var/<KERNEL>/<NAME>/, then each
is loaded in turn in place of the kernel's library and run through its
wrapper in vcvits_tpu_torch/ops/:

* mrf: against `mrf_plain` on small shapes, then on the four decoder
  stages of a 10 s request ([1, 7440, 256] ... [1, 476160, 32]), fp32 and
  bf16 weights: the error (fp32: max |err|, bf16: error RMS, both over the
  output's RMS) and the CUDA-event time of each stage, and the totals.
* flow_coupling: against the plain versions on a ragged batch and at full
  width (max |err| over the output's RMS), then the CUDA-event and device
  (torch.profiler) time of 4 launches of the reverse mode on
  [1, 930, 128], the forward mode, 4 wn_segment launches (16 layers), and
  the reverse at hidden 256.
* int8_conv: a variant named `parent` is an earlier int8_conv.cu with
  the interface before the fused epilogue (per conv: Q2 into a zeroed
  amax, Q1, then PyTorch's residual add, block sum and mean), given as
  `parent=@dir/int8_conv.cu` (say the parent commit's, unpacked by
  `git archive` into a git-ignored directory); every other variant is
  driven through ops/int8_conv.py. Per distinct conv of a 10 s W8A8
  request (chip_smoke.int8_conv_shapes) at B = 1 and 16, fp32 and bf16:
  Q1's CUDA-event time (20 launches; the new interface with the epilogue
  the decode gives the conv, the parent's Q1 alone), each variant's
  output held to the plain version (<= 1 ulp, the emitted maximum
  bit-equal; the parent's after PyTorch's epilogue steps) where it is
  not an ablation; Q2 at conv_pre's input against
  torch.linalg.vector_norm(ord=inf), 200 launches each, by CUDA events and
  in device time (chip_smoke.device_time_ms). Then per request:
  the whole decoder at full width (seeded random weights), the parent's
  op sequence and the new decode in turns (parent, new, new, parent),
  their outputs compared, and each one's device time by class
  (torch.profiler: Q1, Q2, everything else) and kernels a request.
* monotonic_align: a variant named `parent` is the first M1 (one
  256-thread block a row, its interface `monotonic_align(..., B, T_y, T_x,
  stream)` and `monotonic_align_shared_bits`), given as
  `parent=@dir/monotonic_align.cu`; every other variant runs on
  ops/monotonic_align.py's plan (`launch`). At chip_smoke.MAS_SHAPES (the
  parent only up to its T_x cap of 2048), on the same seeded ragged
  inputs: each variant's path against the plain version (0 differing
  entries, except the ablations that drop work), its CUDA-event time (20
  launches) and device time (torch.profiler), in turns (variants, then
  the same in reverse order). Then the base library on other plans at the
  TTS step's shape (R, ring, cluster). A variant built with -DMAS_CLOCKS
  (say `clocks=-DMAS_CLOCKS`) prints its clock64 phase split for each
  shape's longest row and the dependency-chain floor (chip_smoke.mas_chain).

A variant's source must keep the C entry points of the wrapper (or, for
`parent`, the earlier ones). ptxas's
register and spill lines are printed per variant. The named edits match
the source's text exactly and stop the run when it has moved on; those
that drop work give wrong results and are for timing only: they show what
each part of the kernel costs. Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vcvits_tpu_torch.ops import _build  # noqa: E402

# kernel -> name -> [(file, old text, new text)]: source edits a variant may apply
EDITS = {"mrf": {}, "flow_coupling": {
    # timing only: the tensor-core products (and the fragment loads feeding them) dropped
    "nomma": [("tf32_mma.cuh", """  if (first)
    mma_tf32_zero(part, al, bh);
  else
    mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);""", """  if (first) part[0] = part[1] = part[2] = part[3] = 0.f;""")],
    # timing only: no block sent to a peer and none awaited
    "noexchange": [("flow_coupling.cu", "  if (k >= n - 1) return;", "  if (k >= 0) return;"),
                   ("flow_coupling.cu", "expect = (n - 1) * block_bytes;",
                    "expect = 0 * block_bytes;")],
    # timing only: no weight tiles copied (the products run on whatever the ring holds)
    "noring": [("flow_coupling.cu", """  for (int i = threadIdx.x; i < KC * 2 * C4; i += NTHREADS) {""",
                """  for (int i = threadIdx.x; i < 0 * KC * 2 * C4; i += NTHREADS) {""")],
    # timing only: every CTA returns at once (the launch and the cluster's start)
    "noop": [("flow_coupling.cu", """  cluster_arrive();  // matched by the wait before the first copy to a peer""",
              """  cluster_arrive();
  cluster_wait();
  if (a.L > 0) return;""")],
    # timing only: no pre or no post FMAs
    "nopre": [("flow_coupling.cu", "    for (int c = 0; c < a.half; c += 4)",
               "    for (int c = 0; c < 0; c += 4)")],
    "nopost": [("flow_coupling.cu", "      for (int p = 0; p < P; p += 4)",
                "      for (int p = 0; p < 0; p += 4)")],
    # every product straight into the accumulator (no fresh partial sum a tile)
    "nopart": [("flow_coupling.cu",
                """      for (int ab = 0; ab < 2; ++ab) tc::mma_3xtf32(part[mt][ab], ah, al, bh[ab], bl[ab], kk == 0);""",
                """      for (int ab = 0; ab < 2; ++ab) tc::mma_3xtf32(acc[mt][ab], ah, al, bh[ab], bl[ab], false);"""),
               ("flow_coupling.cu",
                """      for (int i = 0; i < 4; ++i) acc[mt][ab][i] += part[mt][ab][i];""",
                """      for (int i = 0; i < 0; ++i) acc[mt][ab][i] += part[mt][ab][i];""")],
    # a 3-deep weight ring (it does not fit at 32 channels a CTA)
    "stages3": [("flow_coupling.cu", "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}}


def make_source(kernel: str, name: str, spec: str):
    """(source path, nvcc flags) of a variant; an edited copy of csrc/ is
    written under build/torch_kernels/var/<kernel>/<name>/."""
    if spec.startswith("@"):
        src, _, rest = spec[1:].partition(" ")
        return src, rest.split()
    flags, edits = [], []
    for part in (spec or name).split("+"):
        if part.startswith("-D"):
            flags.append(part)
        elif part != "base":
            edits += EDITS[kernel][part]
    out = _build.BUILD_DIR / "var" / kernel / name
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, out / f.name)
    for fname, old, new in edits:
        text = (out / fname).read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: an edit's text is not in {fname}: {old[:60]!r}")
        (out / fname).write_text(text.replace(old, new))
    return str(out / f"{kernel}.cu"), flags


def build(kernel: str, name: str, spec: str):
    src, flags = make_source(kernel, name, spec)
    lib = _build.BUILD_DIR / "var" / kernel / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", os.path.dirname(src), "-I",
           str(_build.CSRC), "-o", str(lib), src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    notes = [line.strip() for line in (r.stdout + r.stderr).splitlines()
             if "registers" in line or "spill" in line or "rror" in line or "erialized" in line]
    return name, lib, r.returncode, notes


def use(kernel: str, path) -> None:
    """Load the library at `path` in place of `kernel`'s; its wrapper types
    the new handle at its next launch."""
    _build._LIBS[kernel] = ctypes.CDLL(str(path))


# ---- K1 ------------------------------------------------------------------

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
SMALL = ((32, 1000, 1, KS, DS), (64, 333, 2, KS, DS), (256, 97, 1, KS, DS),
         (128, 20, 1, KS, DS), (256, 55, 1, KS, DS), (64, 500, 1, (3, 5), ((1, 2), (1,))),
         (96, 300, 2, KS, DS), (160, 77, 1, (3,), ((1, 7),)))


def mrf_inputs(rng, c, t, b, ks, ds, wdt, dev):
    x = torch.tensor(rng.standard_normal((b, t, c)), dtype=torch.float32, device=dev)
    blocks = [tuple(torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32, device=dev)
                    .to(wdt).contiguous()
                    for s, sc in (((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1),
                                  ((len(d), k, c, c), 1 / np.sqrt(k * c)), ((len(d), c), 0.1)))
              for k, d in zip(ks, ds)]
    return x, blocks


def mrf_suite(libs, dev) -> None:
    from vcvits_tpu_torch.ops import mrf as K1

    def err(got, ref, wdt):
        return cs.rel_err(got, ref, wdt == torch.bfloat16)[1]

    for name, path in libs.items():
        use("mrf", path)
        for c, t, b, ks, ds in SMALL:
            for wdt in (torch.float32, torch.bfloat16):
                x, blocks = mrf_inputs(np.random.default_rng(c + t), c, t, b, ks, ds, wdt, dev)
                try:
                    e = err(K1.mrf(x, blocks, ks, ds), K1.mrf_plain(x, blocks, ks, ds), wdt)
                    print(f"{name} small C={c} T={t} B={b} {str(wdt)[6:]}: err {e:.3e}")
                except (RuntimeError, ValueError) as exc:
                    print(f"{name} small C={c} T={t} B={b} {str(wdt)[6:]}: failed: {exc}")
    totals = {}
    rng = np.random.default_rng(0)
    for wdt in (torch.float32, torch.bfloat16):
        for t, c in cs.STAGE_SHAPES:
            x, blocks = mrf_inputs(rng, c, t, 1, KS, DS, wdt, dev)
            ref = K1.mrf_plain(x, blocks, KS, DS)
            for name, path in libs.items():
                use("mrf", path)
                try:
                    e = err(K1.mrf(x, blocks, KS, DS), ref, wdt)
                    ms = cs.cuda_ms(lambda: K1.mrf(x, blocks, KS, DS), 5)
                except (RuntimeError, ValueError) as exc:
                    print(f"{name} [1,{t},{c}] {str(wdt)[6:]}: failed: {exc}")
                    continue
                totals.setdefault((name, str(wdt)[6:]), []).append(ms)
                print(f"{name} [1,{t},{c}] {str(wdt)[6:]}: err {e:.3e} ms {ms:.4f}", flush=True)
            del x, blocks, ref
    for (name, label), per in totals.items():
        print(f"total {name} {label}: {sum(per):.4f} ms, per stage "
              f"{', '.join(f'{v:.4f}' for v in per)}")


# ---- K2 ------------------------------------------------------------------

def flow_suite(libs, dev) -> None:
    from vcvits_tpu_torch.ops import flow_coupling as K2

    rng = np.random.default_rng(0)
    h, c, t = cs.FLOW_HID, cs.FLOW_CH, cs.FLOW_FRAMES
    sets = {}
    for hid, ch in ((h, c), (256, 256)):
        ws = [cs.flow_weights(rng, dev, ch // 2, hid) for _ in range(cs.N_FLOWS)]
        conds = [torch.tensor(rng.standard_normal((1, 4 * 2 * hid)) * 0.3, dtype=torch.float32,
                              device=dev) for _ in range(cs.N_FLOWS)]
        x = torch.tensor(rng.standard_normal((1, t, ch)), dtype=torch.float32, device=dev)
        hx = torch.tensor(rng.standard_normal((1, t, hid)), dtype=torch.float32, device=dev)
        sets[hid] = (ws, conds, x, hx)
    mask = torch.ones(1, t, 1, device=dev)
    ragged = (torch.arange(150, device=dev)[None, :] < torch.tensor([[150], [120]],
                                                                     device=dev)).float()[..., None]

    def chain(fn, hid, mode):
        ws, conds, x, hx = sets[hid]
        if mode == "wn":
            y, skip = hx, torch.zeros_like(hx)
            for w, cd in zip(ws, conds):
                y, skip = fn(y, skip, mask, cd, w[2:6])
            return skip
        y = x
        for w, cd in zip(ws, conds):
            y = fn(torch.flip(y, dims=[-1]).contiguous(), mask, cd, w)
        return y

    plain = {"rev": K2.coupling_reverse_plain, "fwd": K2.coupling_forward_plain,
             "wn": K2.wn_segment_plain}
    kern = {"rev": K2.coupling_reverse, "fwd": K2.coupling_forward, "wn": K2.wn_segment}
    refs = {(hid, m): chain(plain[m], hid, m) for hid, m in ((h, "rev"), (h, "fwd"), (h, "wn"),
                                                            (256, "rev"))}
    xs = torch.tensor(rng.standard_normal((2, 150, c)), dtype=torch.float32, device=dev)
    small_w = cs.flow_weights(rng, dev, c // 2, h)
    small_ref = K2.coupling_reverse_plain(xs, ragged, None, small_w)
    for name, path in libs.items():
        use("flow_coupling", path)
        res = {"name": name}
        try:
            got = K2.coupling_reverse(xs, ragged, None, small_w)
            res["err_small"] = cs.rel_err(got, small_ref)[1]
            for (hid, m), ref in refs.items():
                fn = lambda hid=hid, m=m: chain(kern[m], hid, m)  # noqa: E731
                res[f"err_{m}{hid}"] = cs.rel_err(fn(), ref)[1]
                res[f"ms_{m}{hid}"] = cs.cuda_ms(fn, 10)
                res[f"dev_{m}{hid}"] = cs.kernel_device_ms(fn, "wn_stack_kernel", 10)
        except RuntimeError as e:
            res["error"] = str(e)[:200]
        torch.cuda.synchronize()
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in res.items()), flush=True)


# ---- Q1 / Q2 ---------------------------------------------------------------

EDITS["int8_conv"] = {
    # timing only: the quantizer a cast (the code is a byte of the value's bits)
    "castquant": [("int8_conv.cu", """  for (int e = 0; e < 4; ++e) {
    const float pc = fminf(fmaxf(__fmul_rn(v[e], rcp), -127.f), 127.f);
    sum[e] = __fadd_rn(pc, MAGIC);
    near = fminf(near, fabsf(fabsf(__fsub_rn(pc, __fsub_rn(sum[e], MAGIC))) - 0.5f));
  }
  if (near < TIE_TOL) {""", """  for (int e = 0; e < 4; ++e) sum[e] = v[e];
  if (rcp < 0.f) {""")],
    # timing only: the epilogue without the row maximum (no extremes kept, no atomicMax)
    "noemit": [("int8_conv.cu", """  const bool emit_on = a.emit != nullptr, emit_slope_on""",
                """  const bool emit_on = false, emit_slope_on""")],
    # timing only: the input tile is not read (its codes are made from zeros)
    "noload": [("int8_conv.cu", """          return __ldg(reinterpret_cast<const uint4*>(xb + (size_t)t * a.Ci + c));""",
                """          return make_uint4(0u, 0u, (unsigned)t, (unsigned)c);"""),
               ("int8_conv.cu", """    bulk_expect(&raw_bar, bytes);""", """    bulk_expect(&raw_bar, 0);"""),
               ("int8_conv.cu", """    bulk_copy(raw + (lo - row0) * a.Ci,""",
                """    if (bytes == 0xffffffffu) bulk_copy(raw + (lo - row0) * a.Ci,""")],
    # timing only: no products (the accumulators stay 0)
    "nomma": [("int8_conv.cu", """      for (int k0 = 0; k0 < p.ci_pad; k0 += 32) {
        uint32_t af[2][4]""", """      for (int k0 = 0; k0 < 0; k0 += 32) {
        uint32_t af[2][4]""")],
    # timing only: nothing stored (the epilogue computes its values only)
    "nostore": [("int8_conv.cu", """              store2(yr + o, v);""",
                 """              if (v[0] == 1234.5f) store2(yr + o, v);"""),
                ("int8_conv.cu", """            store4(yb + (size_t)t * a.Co""",
                 """            if (y[0] == 1234.5f) store4(yb + (size_t)t * a.Co""")],
    # at least three blocks an SM (at most 85 registers a thread)
    "lb3": [("int8_conv.cu", "__launch_bounds__(32 * WM * WN, 2)", "__launch_bounds__(32 * WM * WN, 3)")],
    # bf16 rounded on the bits with integer ops instead of the conversion unit
    "intrnd": [("int8_conv.cu", """  return __bfloat162float(__float2bfloat16_rn(v));
}""", """  const uint32_t u = __float_as_uint(v);
  const float r = __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  return v != v ? __uint_as_float(0x7fc00000u) : r;
}""")],
}


def parent_lib(path):
    """The parent interface's library: Q1 with 18 arguments, Q2 into a
    caller-zeroed [B] of float bits."""
    lib = ctypes.CDLL(str(path))
    lib.int8_conv1d.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.row_absmax.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.int8_conv1d.restype = lib.row_absmax.restype = ctypes.c_int
    return lib


def parent_absmax(lib, x, slope):
    b = x.shape[0]
    amax = torch.zeros(b, dtype=torch.float32, device=x.device)
    err = lib.row_absmax(x.data_ptr(), amax.data_ptr(), b, x.numel() // b,
                         0.0 if slope is None else slope, slope is not None,
                         x.dtype == torch.bfloat16, _build.current_stream(x.device))
    _build.check(err, "parent row_absmax")
    return amax


def parent_q1(lib, x, qw, pad, bias, d, slope, amax):
    b, t, _ = x.shape
    t_out = t + pad[0] + pad[1] - (qw.k - 1) * d
    y = torch.empty(b, t_out, qw.co, dtype=x.dtype, device=x.device)
    err = lib.int8_conv1d(x.data_ptr(), qw.packed.data_ptr(), qw.scale.data_ptr(),
                          None if bias is None else bias.data_ptr(), amax.data_ptr(), y.data_ptr(),
                          b, t, qw.ci, qw.co, qw.k, d, pad[0], t_out,
                          0.0 if slope is None else slope, slope is not None,
                          x.dtype == torch.bfloat16, _build.current_stream(x.device))
    _build.check(err, "parent int8_conv1d")
    return y


def parent_decode(lib, dec, x, g):
    """The W8A8 decode as the parent ran it: per conv a zeroed amax, Q2 and
    Q1, and the module path's residual adds, block sums and mean in
    PyTorch ops (ResBlock1)."""
    from vcvits_tpu_torch.models.layers import LRELU_SLOPE

    def conv(layer, h, slope):
        c = layer.w8a8_conv()
        return parent_q1(lib, h, c.qw, c.pad, c.bias, c.dilation, slope,
                         parent_absmax(lib, h, slope))

    x = conv(dec.conv_pre, x.to(dec.dtype).contiguous(), None)
    if g is not None and dec.cond is not None:
        x = x + dec.cond(g)[:, None, :]
    for i in range(dec.n_stages):
        up = getattr(dec, f"up_{i}")
        y = conv(up, x, LRELU_SLOPE)
        x = y.reshape(y.shape[0], -1, up.w8a8_conv().qw.co // up.stride)
        xs = None
        for j in range(len(dec.kernel_sizes)):
            blk, h = getattr(dec, f"res_{i}_{j}"), x
            for t in range(len(blk.dilations)):
                xt = conv(getattr(blk, f"c1_{t}"), h, LRELU_SLOPE)
                h = conv(getattr(blk, f"c2_{t}"), xt, LRELU_SLOPE) + h
            xs = h if xs is None else xs + h
        x = xs / dec.block_count
    return torch.tanh(conv(dec.conv_post, x, 0.01))


def device_classes(fn, reps: int = 3):
    """fn's device ms a call by class (Q1, Q2, the rest) and kernels a call,
    from torch.profiler over `reps` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"q1": 0.0, "q2": 0.0, "other": 0.0, "n_q1": 0, "n_q2": 0, "n_other": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("q1" if "int8_conv_kernel" in e.name else
               "q2" if "row_absmax_kernel" in e.name else "other")
        out[key] += (e.time_range.end - e.time_range.start) / 1e3 / reps
        out["n_" + key] += 1
    for key in ("n_q1", "n_q2", "n_other"):
        out[key] /= reps
    return out


def int8_suite(libs, dev) -> None:
    from vcvits_tpu_torch.config import load_config
    from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
    from vcvits_tpu_torch.models.layers import init_weights
    from vcvits_tpu_torch.ops import int8_conv as Q

    parent = {n: parent_lib(p) for n, p in libs.items() if n == "parent"}
    cfg = load_config(cs.CONFIG)
    m = cfg.model
    n_blocks, n_stages = len(m.resblock_kernel_sizes), len(m.upsample_rates)
    gen = torch.Generator(device=dev).manual_seed(8)
    totals = {}
    for name_s, ci, co, k, d, pad, t, slope, mult, _, parts in cs.int8_conv_shapes(
            cfg, cs.INT8_FRAMES):
        t_out = t + pad[0] + pad[1] - (k - 1) * d
        w = torch.randn((co, ci, k), generator=gen, device=dev) / float(np.sqrt(k * ci))
        bias = torch.randn((co,), generator=gen, device=dev) * 0.1
        qw = Q.prepare_w8a8(w)
        line = []
        for b in (1, cs.SERVE_BATCH):
            x32 = torch.randn((b, t, ci), generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                amax = Q.row_absmax_plain(x, slope)
                fused = cs.int8_fused(parts, b, t_out, co, n_blocks,
                                      name_s.startswith(f"mrf_{n_stages - 1}"), dtype, gen, dev)
                ref_emit = None if "emit" not in parts else torch.zeros_like(fused["emit"])
                ref = Q.conv1d_w8a8_plain(x, qw, pad, bias, d, slope, amax=amax,
                                          **{**fused, "emit": ref_emit})
                for name, path in libs.items():
                    if name in parent:  # Q1 alone; the parent ran the epilogue's steps in torch
                        fn = lambda: parent_q1(parent[name], x, qw, pad, bias, d, slope, amax)  # noqa: E731
                    else:
                        use("int8_conv", path)
                        fn = lambda: Q.conv1d_w8a8(x, qw, pad, bias, d, slope, amax=amax,  # noqa: E731
                                                   **fused)
                    try:
                        if "emit" in parts:
                            fused["emit"].zero_()
                        got = fn()
                        torch.cuda.synchronize()
                        note = ""
                        if name not in EDITS["int8_conv"] and "+" not in name:
                            if name in parent:
                                got = Q._epilogue_plain(got, fused.get("residual"),
                                                        fused.get("accum"), fused.get("divisor"),
                                                        None, None)
                            note = f" ulps {cs.ulps(got, ref)}"
                            if name not in parent and "emit" in parts:
                                same = torch.equal(fused["emit"], Q.row_absmax_plain(
                                    got, fused["emit_slope"]))
                                note += " emit " + ("bit-equal" if same else "DIFFERS")
                        ms = cs.cuda_ms(fn, 20)
                    except (RuntimeError, ValueError) as exc:
                        line.append(f"{name} B={b} {str(dtype)[6:]} failed: {exc}")
                        continue
                    acc = totals.setdefault((name, b, str(dtype)[6:]), [0.0, 0.0])
                    acc[0] += mult * ms
                    line.append(f"{name} B={b} {str(dtype)[6:]} {ms:.4f}{note}")
                    del got
                if slope is None:  # conv_pre's input: Q2 against the one PyTorch call
                    lib_ms = cs.cuda_ms(lambda: torch.linalg.vector_norm(
                        x, ord=float("inf"), dim=(1, 2)), 200)
                    q2 = []
                    for name, path in libs.items():
                        if name in parent:
                            fn = lambda: parent_absmax(parent[name], x, None)  # noqa: E731
                        else:
                            use("int8_conv", path)
                            fn = lambda: Q.row_absmax(x, None)  # noqa: E731
                        same = torch.equal(fn(), amax)
                        q2.append(f"{name} {cs.cuda_ms(fn, 200):.4f} (device "
                                  f"{cs.device_time_ms(fn):.4f})" + ("" if same else " DIFFERS"))
                    line.append(f"Q2 at conv_pre B={b} {str(dtype)[6:]}: " + ", ".join(q2)
                                + f", vector_norm(ord=inf) {lib_ms:.4f} (device "
                                f"{cs.device_time_ms(lambda: torch.linalg.vector_norm(x, ord=float('inf'), dim=(1, 2))):.4f})")
                del x, ref, fused
            del x32
            torch.cuda.empty_cache()
        print(f"int8 {name_s} [{ci}->{co}, k {k}, d {d}, T {t}] x{mult}: " + "; ".join(line),
              flush=True)
    for (name, b, label), (ms, _) in totals.items():
        print(f"int8 per-shape sum x launches, {name} B={b} {label}: Q1 {ms:.4f} ms")

    # the whole decoder, per request (B = 1) and per daemon batch (B = 16)
    for dtype in (torch.float32, torch.bfloat16):
        dec = init_weights(HiFiGANGenerator(
            m.inter_channels, m.resblock, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
            m.upsample_rates, m.upsample_initial_channel, m.upsample_kernel_sizes,
            gin_channels=m.gin_channels, quant_int8=True, dtype=dtype), 0).to(dev)
        for b in (1, cs.SERVE_BATCH):
            rng = torch.Generator(device=dev).manual_seed(b)
            z = torch.randn((b, cs.INT8_FRAMES, m.inter_channels), generator=rng,
                            device=dev).to(dtype)
            g = torch.randn((b, m.gin_channels), generator=rng, device=dev).to(dtype)
            runs, outs = {}, {}
            order = [n for n in libs if n in parent] + [n for n in libs if n not in parent]
            order = order + order[::-1]
            with torch.no_grad():
                for name in order:
                    if name in parent:
                        fn = lambda: parent_decode(parent[name], dec, z, g)  # noqa: E731
                    else:
                        use("int8_conv", libs[name])
                        fn = lambda: dec(z, g)  # noqa: E731
                    outs.setdefault(name, fn())
                    ms = cs.cuda_ms(fn, 5)
                    prof = device_classes(fn)
                    runs.setdefault(name, []).append((ms, prof))
            ref_name = order[0]
            for name, rs in runs.items():
                diff = (outs[name].float() - outs[ref_name].float()).abs()
                ms = ", ".join(f"{r[0]:.3f}" for r in rs)
                p = rs[-1][1]
                print(f"int8 decode {str(dtype)[6:]} B={b} {name}: {ms} ms a call (CUDA events); "
                      f"device Q1 {p['q1']:.4f} ms x{p['n_q1']:.0f}, Q2 {p['q2']:.4f} ms "
                      f"x{p['n_q2']:.0f}, other {p['other']:.4f} ms x{p['n_other']:.0f}; Q1 + Q2 "
                      f"{p['q1'] + p['q2']:.4f} ms; output vs {ref_name}: max |diff| "
                      f"{float(diff.max()):.3e}, {int((diff > 0).sum())} of {diff.numel()} "
                      f"samples differ", flush=True)
            del z, g, outs
        del dec
        torch.cuda.empty_cache()


# ---- M1 --------------------------------------------------------------------

EDITS["monotonic_align"] = {
    # timing only: no path written (no zeroing blocks' stores, no 1s)
    "nowrite": [("monotonic_align.cu", """    zero_floats(prow + lo, hi - lo);""",
                 """    if (hi < lo) zero_floats(prow + lo, hi - lo);"""),
                ("monotonic_align.cu",
                 """    store_one_if(prow + (unsigned)(xx * t_y + y), lane < WINDOW && (y | xx) >= 0);""",
                 """    store_one_if(prow + (unsigned)(xx * t_y + y), lane < WINDOW && y > t_y);""")],
    # timing only: no backtrack (the DP, then the zeroed path)
    "noback": [("monotonic_align.cu", """  cluster_wait();  // the zeroing blocks are done
""", """  cluster_wait();  // the zeroing blocks are done
  if (yl > 0) return;
""")],
    # the scores read by the DP warps from device memory as each column is
    # computed (no ring between them; the copy warp still fills it)
    "nostage": [("monotonic_align.cu", """template <int R, bool PREV>
__device__""", """template <int R>
__device__ __forceinline__ void load_global(float (&v)[R], const float* col, int x0, int xl) {
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = x0 + k < xl ? __ldg(col + x0 + k) : NEG_INF;
}

template <int R, bool PREV>
__device__"""), ("monotonic_align.cu", """  auto column = [&](const float (&v)[R], int y) {
""", """  auto column = [&](const float (&v_staged)[R], int y) {
    float v[R];
    load_global<R>(v, a.value + ((size_t)b * a.t_y + y) * a.t_x, x0, xl);
""")],
    # the decisions summed into two accumulators (even and odd x) instead of one
    "twoacc": [("monotonic_align.cu", """    float bits_f = 0.f;  // the decisions as a float, sum of 2^k where x0 + k comes from diag
""", """    float bits_f = 0.f;  // the decisions as a float, sum of 2^k where x0 + k comes from diag
    float bits_g = 0.f;
"""), ("monotonic_align.cu",
       """    for (int k = R - 2; k >= 1; --k) step(best[k], best[k - 1], v[k], bits_f, (float)(1 << k));""",
       """    for (int k = R - 2; k >= 1; --k)
      step(best[k], best[k - 1], v[k], (k & 1) ? bits_f : bits_g, (float)(1 << k));"""),
       ("monotonic_align.cu", """__fadd_rn(bits_f, 8388608.f)""",
        """__fadd_rn(__fadd_rn(bits_f, bits_g), 8388608.f)""")],
}
MAS_EXACT_ABLATIONS = ("nostage", "twoacc")  # edits that keep the function


def mas_parent_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.monotonic_align.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.monotonic_align.restype = ctypes.c_int
    lib.monotonic_align_shared_bits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.monotonic_align_shared_bits.restype = ctypes.c_int
    return lib


def mas_parent(lib, value, xl, yl):
    b, t_y, t_x = value.shape
    where = lib.monotonic_align_shared_bits(t_y, t_x)
    path = torch.empty(b, t_x, t_y, device=value.device)
    bits = None if where else torch.empty(b, t_y, (t_x + 31) // 32, dtype=torch.int32,
                                          device=value.device)
    err = lib.monotonic_align(value.data_ptr(), xl.data_ptr(), yl.data_ptr(), path.data_ptr(),
                              None if bits is None else bits.data_ptr(), b, t_y, t_x,
                              _build.current_stream(value.device))
    _build.check(err, "parent monotonic_align")
    return path


def mas_suite(libs, dev) -> None:
    from vcvits_tpu_torch.ops import monotonic_align as M1

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent = {n: mas_parent_lib(p) for n, p in libs.items() if n == "parent"}
    rng = np.random.default_rng(0)
    for label, b, t_x, t_y in cs.MAS_SHAPES:
        value = torch.tensor(rng.standard_normal((b, t_y, t_x)) * 30, dtype=torch.float32,
                             device=dev)
        xl = rng.integers(t_x // 3, t_x + 1, b)
        yl = np.maximum(rng.integers(t_y // 2, t_y + 1, b), xl)
        xl[-1], yl[-1] = t_x, t_y
        xl_t, yl_t = (torch.tensor(a, dtype=torch.int32, device=dev) for a in (xl, yl))
        ref = M1.maximum_path_plain(value.transpose(1, 2), M1.length_mask(xl_t, yl_t, t_x, t_y))
        shape = M1.plan(t_x, t_y, b, sms)
        names = [n for n in libs if n not in parent or t_x <= 2048]
        runs = {}
        for name in names + names[::-1]:
            if name in parent:
                fn = lambda: mas_parent(parent[name], value, xl_t, yl_t)  # noqa: E731
            else:
                use("monotonic_align", libs[name])
                fn = lambda: M1.launch(value, xl_t, yl_t, shape)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            diff = int((got != ref).sum())
            runs.setdefault(name, []).append(
                (cs.cuda_ms(fn, 20), cs.kernel_device_ms(fn, "mas_kernel", 10), diff))
            del got
        for name, rs in runs.items():
            exact = name not in EDITS["monotonic_align"] or name in MAS_EXACT_ABLATIONS
            print(f"M1 {label} (B={b}, T_x={t_x}, T_y={t_y}) {name}: events ms "
                  + ", ".join(f"{r[0]:.4f}" for r in rs) + "; device ms "
                  + ", ".join(f"{r[1]:.4f}" for r in rs)
                  + f"; {rs[0][2]} of {ref.numel()} entries differ"
                  + ("" if exact else " (ablation: drops work)"), flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            if name in parent or not hasattr(lib, "monotonic_align_clocks"):
                continue
            counts = cs.mas_clocks(path, value, xl_t, yl_t, shape)
            t0 = counts[:, -2].min()
            print(f"M1 {label} {name} clocks, each row (yl, block 0 start and end us after the "
                  f"first start, cycles DP loop, backtrack): " + "; ".join(
                      f"{y} {(r[-2] - t0) / 1e3:.2f}-{(r[-1] - t0) / 1e3:.2f} {r[3]} {r[7]}"
                      for y, r in zip(yl.tolist(), counts)))
            chain = cs.mas_chain(counts[-1], t_y)
            print(f"M1 {label} {name} clocks, the full row: " + ", ".join(
                f"{k} {v}" for k, v in chain["clocks"].items())
                + f"; {chain['step_cycles']:.1f} cycles a column step, backtrack "
                f"{chain['backtrack_cycles']} cycles, chain floor {chain['floor_cycles']:.0f} "
                f"cycles = {chain['floor_ms']:.4f} ms at {chain['ghz']:.3f} GHz", flush=True)
        if "base" in libs:  # other launch shapes on the base library
            use("monotonic_align", libs["base"])
            none = torch.zeros_like(xl_t)  # every row empty: the launch and the zeroing alone
            fn = lambda: M1.launch(value, none, yl_t, shape)  # noqa: E731
            print(f"M1 {label} base, every row empty: events ms {cs.cuda_ms(fn, 20):.4f}, device "
                  f"ms {cs.kernel_device_ms(fn, 'mas_kernel', 10):.4f}", flush=True)
            alts = [M1.plan(t_x, t_y, b, sms, r) for r in (8, 16)]
            if label == cs.MAS_SHAPES[0][0]:
                for r, (stages, cols), cluster in ((8, (4, 16), 4), (8, (4, 32), 4), (8, (2, 32), 2),
                                                  (8, (2, 32), 1)):
                    warps = -(-t_x // (32 * r))
                    slots = 1 << (stages * cols).bit_length()
                    alts.append(M1.Plan(r, warps, stages, cols, slots, True, cluster,
                                        M1.smem_bytes(t_y, r, warps, stages, cols, slots, True)))
            for alt in alts:
                if alt is None:
                    continue
                r, warps, stages, cols, cluster = (alt.lanes_r, alt.warps, alt.stages, alt.cols,
                                                   alt.cluster)
                fn = lambda: M1.launch(value, xl_t, yl_t, alt)  # noqa: E731
                diff = int((fn() != ref).sum())
                print(f"M1 {label} base on R={r} warps={warps} ring {stages} x {cols} "
                      f"{'shared' if alt.shared_bits else 'global'} decisions, cluster "
                      f"{cluster}: events ms {cs.cuda_ms(fn, 20):.4f}, device ms "
                      f"{cs.kernel_device_ms(fn, 'mas_kernel', 10):.4f}; {diff} entries differ",
                      flush=True)
        del value, ref
        torch.cuda.empty_cache()


SUITES = {"mrf": mrf_suite, "flow_coupling": flow_suite, "int8_conv": int8_suite,
          "monotonic_align": mas_suite}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in SUITES:
        print(f"usage: torch_kernel_variants.py {{{','.join(SUITES)}}} [VARIANT ...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kernel = sys.argv[1]
    specs = [a.partition("=") for a in sys.argv[2:]] or [("base", "", "")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.info_line())
    (_build.BUILD_DIR / "var" / kernel).mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(kernel, s[0], s[2]), specs))
    libs = {}
    for name, path, rc, notes in built:
        print(f"--- {name}: nvcc exit {rc}; " + "; ".join(notes[:24]))
        if rc == 0:
            libs[name] = path
    SUITES[kernel](libs, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
