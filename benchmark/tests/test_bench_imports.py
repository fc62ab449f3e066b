"""Nothing the benchmark runs loads JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program; without a card
the measurement path fails and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vcvits_tpu"}


def loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    tops = loaded("import benchmark.reference.vc, benchmark.reference.train, "
                  "benchmark.weights, benchmark.flops, benchmark.roofline, benchmark.synth")
    assert not tops & FORBIDDEN
    assert "vcvits_tpu_torch" not in tops


def test_harness_and_program_load_no_jax():
    tops = loaded("import benchmark.harness, benchmark.tracing, benchmark.readings, "
                  "benchmark.sweep, benchmark.faults\n"
                  "import benchmark.loops.open_loop_serve, benchmark.loops.closed_loop_convert, "
                  "benchmark.loops.train_steps\n"
                  "import vcvits_tpu_torch.infer, vcvits_tpu_torch.serving, "
                  "vcvits_tpu_torch.train.step")
    assert not tops & FORBIDDEN
    assert "vcvits_tpu_torch" in tops


@pytest.mark.parametrize("workload", ["vc48k_base.train", "vc_xl.convert"])
def test_no_card_no_result(workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_harness_refuses_a_loaded_jax_name():
    from benchmark import harness

    sys.modules["vcvits_tpu.fake_for_test"] = sys.modules["os"]
    try:
        assert harness.forbidden_modules() == ["vcvits_tpu.fake_for_test"]
    finally:
        del sys.modules["vcvits_tpu.fake_for_test"]
    assert "vcvits_tpu_torch" not in [m.split(".")[0] for m in harness.forbidden_modules()]
