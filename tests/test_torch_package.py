"""Guards of the PyTorch port's package boundary and device rules.

* No module under vcvits_tpu_torch/, and not chip_smoke.py, imports jax,
  flax or vcvits_tpu.
* Importing the package loads no JAX.
* Entry points refuse to run on the CPU unless asked to.
* On CPU tensors the kernel wrappers take their plain versions and count
  no launch.
* The port's config loads the repo's JSON configs exactly as JAX's does.
"""

import ast
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from vcvits_tpu.config import load_config as jax_load_config
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.ops.flow_coupling import coupling_reverse, coupling_reverse_plain
from vcvits_tpu_torch.ops.mrf import mrf, mrf_plain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vcvits_tpu_torch")
FORBIDDEN = ("jax", "flax", "vcvits_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = [f"{os.path.relpath(path, ROOT)}: {mod}" for path in paths for mod in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_loads_no_jax():
    code = ("import sys, vcvits_tpu_torch, vcvits_tpu_torch.infer, "
            "vcvits_tpu_torch.convert.from_jax; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vcvits_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_cpu_by_default(monkeypatch):
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(ROOT, "configs", "48k_base.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoiceConverter(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesizerSVC.from_config(cfg)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    _build.LAUNCHES.clear()
    c, ks, ds = 8, (3,), ((1, 2),)
    x = torch.tensor(rng.standard_normal((1, 20, c)), dtype=torch.float32)
    blk = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                for s in ((2, 3, c, c), (2, c), (2, 3, c, c), (2, c)))
    assert torch.equal(mrf(x, [blk], ks, ds), mrf_plain(x, [blk], ks, ds))

    h, half, n = 4, 2, 4
    w = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              for s in ((half, h), (h,), (n, 5, h, 2 * h), (n, 2 * h), (n, h, 2 * h),
                        (n, 2 * h), (h, half), (half,)))
    xf = torch.tensor(rng.standard_normal((1, 20, 2 * half)), dtype=torch.float32)
    mask = torch.ones(1, 20, 1)
    assert torch.equal(coupling_reverse(xf, mask, None, w),
                       coupling_reverse_plain(xf, mask, None, w))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", ["48k_base.json", "base.json"])
def test_config_loads_like_jax(name):
    path = os.path.join(ROOT, "configs", name)
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()


def test_cuda_sources_are_package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert set(data["vcvits_tpu_torch"]) == {"csrc/*.cu", "csrc/*.cuh"}
    for name in _build.KERNEL_SOURCES:
        assert os.path.exists(os.path.join(PKG, "csrc", f"{name}.cu"))
