"""The port's multi-GPU layer (vcvits_tpu_torch/parallel/) on the CPU.

* `distributed_init`'s contract, JAX's four cases (tests/test_mesh.py),
  `make_mesh`'s shape check and `shard_batch`'s rows.
* The tensor-parallel rule against JAX's: over `init_params`' eval_shape
  trees of both shipped configs, the parameters `tp_spec` shards (mapped
  through params_from_jax's names and layouts) are exactly those
  `vcvits_tpu.parallel.mesh._tp_spec` marks, on the matching axis: 552
  generator and 54 discriminator tensors on base.json, 131 and 54 on
  48k_base, `up_0` on its input side.
* Spawned ranks over gloo (one thread each, a file store, float32, TF32
  off; tests/torch_parallel_ranks.py), against the one-process step on the
  same global batch and injected global draws, dropout on: DP = 2, TP = 2
  and DP2 x TP2 steps (the dry run's config, whose conv_pre, up_0 and
  speaker layers are sharded), every metric to rtol 1e-5 and every
  gradient to rtol 1e-5 with an atol of 1e-5 of the tensor's largest; the
  same DP and TP steps with a collective left out fail that check and
  chip_smoke.py's per-group relative L2 limit; a
  WN at hidden 256 sharded over two ranks (in_N's halves split between the
  gate's tanh and sigmoid) against the whole module, forward, gradients
  and K2's WaveNet mode on the gathered weights; base.json's decoder under
  TP, whose gradients move no more than a 1e-7 nudge of the input moves
  one process's (tests/test_torch_parallel_train.py has the
  loop, the TTS step, the training CLIs and the dry run).
* `ServingDaemon(devices=["cpu", "cpu"])` against one replica, `cli.serve
  --data-parallel 2`, and `cli.train --model-parallel 2` on one process
  refused.
"""

import json
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parallel_ranks as ranks
from tests.test_torch_streaming import CFG as STREAM_CFG, HUBERT as STREAM_HUBERT
from tests.test_torch_streaming import converters  # noqa: F401 (fixture)
from vcvits_tpu.config import load_config as jax_load_config
from vcvits_tpu.parallel.mesh import _tp_spec
from vcvits_tpu.train.step import init_params
from vcvits_tpu_torch.convert.from_jax import _convert_leaf
from vcvits_tpu_torch.parallel import mesh as mesh_mod
from vcvits_tpu_torch.parallel.dryrun import launch, tiny_batch, tiny_config
from vcvits_tpu_torch.parallel.mesh import (
    Mesh, distributed_init, make_mesh, shard_batch, tp_spec)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ranks.RTOL


# ------------------------------------------------------- distributed_init

class _FakeDist:
    def __init__(self, exc=None, initialized=False):
        self.exc = exc
        self.initialized = initialized
        self.calls = []

    def is_initialized(self):
        return self.initialized

    def init_process_group(self, **kwargs):
        self.calls.append(kwargs)
        if self.exc is not None:
            raise self.exc
        self.initialized = True

    def get_world_size(self):
        return 1


def _no_cluster_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "VCVITS_NO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)


def test_escape_hatch_skips_init(monkeypatch):
    fake = _FakeDist()
    monkeypatch.setattr(mesh_mod, "dist", fake)
    monkeypatch.setenv("VCVITS_NO_DISTRIBUTED", "1")
    assert distributed_init(init_method="tcp://10.0.0.1:1234", world_size=2, rank=0) is False
    assert fake.calls == []


def test_genuine_failure_raises(monkeypatch):
    fake = _FakeDist(RuntimeError("timed out connecting to the store at 10.0.0.1:1234"))
    monkeypatch.setattr(mesh_mod, "dist", fake)
    _no_cluster_env(monkeypatch)
    with pytest.raises(RuntimeError, match="timed out"):
        distributed_init(init_method="tcp://10.0.0.1:1234", world_size=4, rank=0,
                         backend="gloo")
    # torchrun's environment alone starts init too, and its failure raises
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError):
        distributed_init()
    assert len(fake.calls) == 2 and fake.calls[0]["backend"] == "gloo"


def test_already_initialized_is_benign(monkeypatch):
    fake = _FakeDist(RuntimeError("must not be called"), initialized=True)
    monkeypatch.setattr(mesh_mod, "dist", fake)
    _no_cluster_env(monkeypatch)
    assert distributed_init(init_method="tcp://10.0.0.1:1234", world_size=2, rank=0) is True
    assert fake.calls == []


def test_no_cluster_env_is_benign_without_kwargs(monkeypatch):
    fake = _FakeDist(ValueError("bad init_method"))
    monkeypatch.setattr(mesh_mod, "dist", fake)
    _no_cluster_env(monkeypatch)
    assert distributed_init() is False  # a plain single-process run
    assert fake.calls == []
    with pytest.raises(ValueError):
        distributed_init(init_method="tcp://10.0.0.1:1234", world_size=2, rank=0,
                         backend="gloo")


def test_make_mesh_shapes():
    m = make_mesh()  # one process
    assert (m.data, m.model, m.rank, m.active, m.is_main) == (1, 1, 0, True, True)
    with pytest.raises(ValueError, match="2x2 != 1"):
        make_mesh(data=2, model=2)
    # the grid is data-major, the model index the fast one (JAX's reshape)
    grid = [(Mesh(2, 2, r).data_rank, Mesh(2, 2, r).model_rank) for r in range(4)]
    assert grid == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shard_batch_rows():
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "n": torch.arange(8)}
    for r in range(4):
        rows = shard_batch(batch, Mesh(2, 2, r))  # data rank r // 2 of 2
        lo = (r // 2) * 4
        np.testing.assert_array_equal(rows["x"], batch["x"][lo:lo + 4])
        assert rows["n"].tolist() == list(range(lo, lo + 4))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": np.zeros((3, 2))}, Mesh(2, 1, 0))


# ------------------------------------------------------ the TP rule vs JAX

def _torch_axis(path: str, shape, axis: int) -> tuple:
    """The port's name and the torch axis of flax axis `axis` of a leaf,
    through params_from_jax's renaming and transposes (found on a small
    array with distinct axis sizes)."""
    sizes = (2, 3, 5, 7)[:len(shape)]
    name, arr = _convert_leaf(path, np.zeros(sizes, np.float32))
    return name, list(arr.shape).index(sizes[axis])


@pytest.mark.parametrize("config,n_gen,n_disc", [("base.json", 552, 54),
                                                 ("48k_base.json", 131, 54)])
def test_tp_rule_matches_jax(config, n_gen, n_disc):
    cfg = jax_load_config(os.path.join(ROOT, "configs", config))
    b, t16 = 1, 2560 * 4
    batch = {"x_wav": jnp.zeros((b, t16)), "x_wav_lengths": jnp.full((b,), t16, jnp.int32),
             "x_pitch": jnp.zeros((b, t16 // 320), jnp.int32),
             "y_wav": jnp.zeros((b, 3 * t16)), "y_wav_lengths": jnp.full((b,), 3 * t16, jnp.int32),
             "sid": jnp.zeros((b,), jnp.int32)}
    g, d = jax.eval_shape(lambda k: init_params(cfg, k, batch), jax.random.PRNGKey(0))
    wants = []
    for tree, n_expect in ((g, n_gen), (d, n_disc)):
        want, got = {}, {}
        wants.append(want)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            jax_name = ".".join(getattr(p, "key", str(p)) for p in path)
            spec = tuple(_tp_spec(path, leaf))
            name, arr = _convert_leaf(jax_name, np.broadcast_to(np.float32(0), leaf.shape))
            if "model" in spec:
                want[name] = _torch_axis(jax_name, leaf.shape, spec.index("model"))[1]
            dim = tp_spec(name, arr.shape)
            if dim is not None:
                got[name] = dim
        assert len(want) == n_expect
        assert got == want
    if config == "base.json":
        assert wants[0]["dec.up_0.v"] == 0  # the input side of [in, out, k]


# ------------------------------------------------------- spawned step parity

@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    cfg = tiny_config(2)  # the dry run's, float32
    batch = tiny_batch(2)
    t_spec = batch["y_wav"].shape[1] // cfg["data"]["hop_length"]
    draws = ranks.global_draws(cfg, 2, t_spec)
    tmp = str(tmp_path_factory.mktemp("layouts"))
    res = launch(ranks.step_layouts, 4, cfg, batch, draws, workdir=tmp)
    return ranks.one_step(cfg, batch, draws), res[0], res[2]


def test_dp2_step_matches_one_process(layouts):
    one, r0, _ = layouts
    ranks.assert_step_close(r0["dp2"], one)


def test_tp2_step_matches_one_process(layouts):
    one, _, r2 = layouts
    ranks.assert_step_close(r2["tp2"], one)


def test_dp2_tp2_step_matches_one_process(layouts):
    one, r0, r2 = layouts
    ranks.assert_step_close(r0["dp2xtp2"], one)
    ranks.assert_step_close(r2["dp2xtp2"], one)


@pytest.mark.parametrize("layout,fault", [("dp2", "sum_grads"), ("tp2", "copy_to")])
def test_planted_fault_fails_both_checks(layouts, layout, fault):
    """A collective left out (`ranks.planted`) fails this file's check and
    chip_smoke.py's per-group relative L2 limit, which the faultless step
    meets."""
    one, r0, r2 = layouts
    rec = r0 if layout == "dp2" else r2
    with pytest.raises(AssertionError):
        ranks.assert_step_close(rec[f"{layout}_{fault}"], one)

    def card_names(step):  # g.enc_p... -> gen.enc_p..., d.mpd... -> disc.mpd...
        m, g = step
        return m, {{"g": "gen", "d": "disc"}[k[0]] + k[1:]: v for k, v in g.items()}

    assert not chip_smoke.off_groups(chip_smoke._compare_steps(*card_names(rec[layout]),
                                                               *card_names(one)))
    off = chip_smoke.off_groups(chip_smoke._compare_steps(*card_names(rec[f"{layout}_{fault}"]),
                                                          *card_names(one)))
    assert off, f"{fault} planted, yet every group within its limit"


def test_wavenet_under_tp_matches_whole(layouts):
    wn = layouts[1]["wn"]
    (y0, gx0, g0, f0, tp0), (y1, gx1, g1, f1, tp1) = wn[False], wn[True]
    assert tp0 == [] and tp1 == ["cond_layer.v", "in_0.v", "in_1.v", "res_skip_0.v"]
    torch.testing.assert_close(y1, y0, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(gx1, gx0, rtol=RTOL, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=RTOL,
                                   atol=ranks.GRAD_SHARE * float(g0[k].abs().max()), msg=k)
    torch.testing.assert_close(f1, f0, rtol=0, atol=0)  # the same gathered weights
    torch.testing.assert_close(f0, y0, rtol=1e-4, atol=1e-5)


def test_decoder_under_tp_moves_gradients_no_more_than_a_nudge(tmp_path):
    """The decoder's gradient is discontinuous at every leaky ReLU's kink: at
    base.json's widths a 1e-7 relative change of the input moves one
    process's gradients by up to a few % of a tensor's largest (activations
    that cross 0 take the other slope). TP's summation order is such a
    change: its output matches the whole decoder to 1e-6, and no gradient
    moves by more than twice what the nudge moves it (plus 1e-5 of the
    tensor's largest)."""
    rec = launch(ranks.decoder_kinks, 2, workdir=str(tmp_path))[0]
    assert rec["y_tp"] < 1e-6
    assert max(rec["nudged"].values()) > 1e-3  # the kinks are there to cross
    bad = {k: (v, rec["nudged"][k]) for k, v in rec["tp"].items()
           if v > 2 * rec["nudged"][k] + 1e-5}
    assert not bad, bad


# ------------------------------------------------------------ serving, CLIs

def test_daemon_two_replicas_equal_one(converters):  # noqa: F811
    from tests.test_torch_serving import _prep
    from vcvits_tpu_torch.serving import ServingDaemon

    vc = converters[1]
    reqs = [_prep(vc, f) for f in (220.0, 330.0, 440.0)]
    outs = {}
    for devices in (None, ["cpu", "cpu"]):
        with ServingDaemon(vc, max_batch=4, window_ms=200, devices=devices) as daemon:
            futs = [daemon.submit(w, p, n, speaker_id=i, rng_seed=5)
                    for i, (w, p, n) in enumerate(reqs)]
            outs[devices is None] = [f.result(timeout=120) for f in futs]
            assert daemon.stats()["batches"] == 1
        if devices:
            assert [str(d) for d in daemon.devices] == ["cpu", "cpu"]
    for a, b in zip(outs[True], outs[False]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="power of two"):
        ServingDaemon(vc, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="max_batch"):
        ServingDaemon(vc, max_batch=1, devices=["cpu", "cpu"])


def test_cli_serve_data_parallel(converters, tmp_path, monkeypatch):  # noqa: F811
    from vcvits_tpu_torch import serving
    from vcvits_tpu_torch.cli import serve as cli
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    vc = converters[1]
    workdir = tmp_path / "run"
    mgr = CheckpointManager(str(workdir / "checkpoints"))
    mgr.save(3, {"step": 3, "gen": vc.gen.state_dict()})
    mgr.wait()
    (workdir / "config.json").write_text(json.dumps(STREAM_CFG))
    monkeypatch.setattr(synthesizer, "hubert_config_for",
                        lambda channels: HubertConfig(**STREAM_HUBERT))
    servers, daemons = [], []
    real_serve = serving.serve_http

    def recording_serve_http(daemon, **kw):
        daemons.append(daemon)
        servers.append(real_serve(daemon, **{**kw, "port": 0}))
        return servers[-1]

    monkeypatch.setattr(serving, "serve_http", recording_serve_http)
    thread = threading.Thread(target=cli.main, args=([
        "--workdir", str(workdir), "-a", "cpu", "--max-batch", "2", "--window-ms", "5",
        "--data-parallel", "2"],), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 120
        while not servers and time.monotonic() < deadline:
            time.sleep(0.05)
        port = servers[0].server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as resp:
            assert resp.status == 200
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert [str(d) for d in daemons[0].devices] == ["cpu", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.test_torch_data import make_corpus, tiny_cfg

    tmp = tmp_path_factory.mktemp("cli_corpus")
    fl = make_corpus(tmp)
    return tmp, tiny_cfg(tmp, fl, steps_per_epoch=None)


def test_cli_train_refuses_a_misconfigured_group(corpus, tmp_path):
    from vcvits_tpu_torch.cli import train as cli

    _, cfg = corpus
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="model_parallel=2 does not divide 1 ranks"):
        cli.main(["-c", str(cfg_path), "-a", "cpu", "-s", "--workdir", str(tmp_path / "logs"),
                  "--model-parallel", "2"])
