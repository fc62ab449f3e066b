#!/usr/bin/env python3
"""Compare builds of one of the port's CUDA kernels in one run on one GPU.

    python3 tools/torch_kernel_variants.py KERNEL [VARIANT ...]

KERNEL is `mrf` (K1, csrc/mrf.cu) or `flow_coupling` (K2,
csrc/flow_coupling.cu). A VARIANT is `NAME` (the source as it is for
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

A variant's source must keep the C entry points of the wrapper. ptxas's
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


SUITES = {"mrf": mrf_suite, "flow_coupling": flow_suite}


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
        print(f"--- {name}: nvcc exit {rc}; " + "; ".join(notes[:8]))
        if rc == 0:
            libs[name] = path
    SUITES[kernel](libs, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
