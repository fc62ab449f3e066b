"""Rank functions for tests/test_torch_parallel.py, run in spawned processes
by vcvits_tpu_torch/parallel/dryrun.py:launch (gloo on the CPU, one thread
a rank). Importable without JAX, so a spawned rank starts with torch only.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from vcvits_tpu_torch.parallel.dryrun import TINY_HUBERT


RTOL = 1e-5
GRAD_SHARE = 1e-5  # gradient atol, as a share of the tensor's largest


def assert_step_close(got, want):
    """(metrics, gradients) of a multi-rank step against the one-process
    step's: every metric to rtol 1e-5 (atol 1e-9, for the discriminator
    terms near 0) and every gradient to rtol 1e-5 with an atol of 1e-5 of
    the tensor's largest."""
    (gm, gg), (wm, wg) = got, want
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=RTOL, atol=1e-9, err_msg=k)
    assert gg.keys() == wg.keys()
    # an attention's key bias has no gradient in exact arithmetic (softmax
    # ignores a shift of every key): it is rounding noise of its model's
    # scale, held to that model's largest gradient
    scale = {side: max(float(w.abs().max()) for k, w in wg.items() if k[0] == side)
             for side in "gd"}
    for k in wg:
        w = wg[k]
        ref = scale[k[0]] if k.endswith(("conv_k.bias", "k_proj.bias")) else float(w.abs().max())
        torch.testing.assert_close(gg[k], w, rtol=RTOL, atol=GRAD_SHARE * ref + 1e-12,
                                   msg=lambda m, k=k: f"{k}: {m}")


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted while the block runs, to show that a comparison
    catches it: "copy_to" (a column-parallel layer's input gradient not
    summed over the model group: copy_to's backward without its
    all_reduce) or "sum_grads" (gradients not summed over the data group)."""
    from vcvits_tpu_torch.parallel import tp
    from vcvits_tpu_torch.parallel.mesh import Mesh

    owner, attr, fake = {
        "copy_to": (tp._CopyTo, "backward", staticmethod(lambda ctx, grad: (grad, None))),
        "sum_grads": (Mesh, "sum_grads", lambda self, params: None)}[fault]
    saved = owner.__dict__[attr]
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def _block_tensorboard():
    # the real import loads TensorFlow (seconds a process); the logger
    # falls back to logging scalars
    sys.modules["torch.utils.tensorboard"] = None


def one_step(cfg_dict, batch, draws, mesh=None, device="cpu"):
    """One TrainStep from seed 0 on `batch` (this rank's rows) with the
    global `draws` -> (metrics, whole G and D gradients by name)."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.parallel.mesh import full_tensor
    from vcvits_tpu_torch.train.step import StepDraws, TrainStep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    step = TrainStep(Config.from_dict(cfg_dict), device=device,
                     hubert_cfg=HubertConfig(**TINY_HUBERT), seed=0, mesh=mesh)
    metrics = step(to_device(batch, device),
                   StepDraws(**{k: torch.as_tensor(v, device=device) for k, v in draws.items()}))
    grads = {}
    for side, module, tp in (("g", step.gen, step.g_tp), ("d", step.disc, step.d_tp)):
        for name, p in module.named_parameters():
            if p.grad is not None:
                grads[f"{side}.{name}"] = full_tensor(p.grad, tp.get(name), step.mesh).cpu()
    return {k: float(v) for k, v in metrics.items()}, grads


def step_layouts(rank, n, cfg_dict, batch, draws):
    """4 ranks: DP=2 on ranks 0-1 beside TP=2 on ranks 2-3, each again with
    its collective's fault planted (`planted`: "sum_grads", "copy_to"),
    then DP2 x TP2 on all four; the WN at hidden 256 (its in_N split
    between the gate's halves) sharded over ranks 0-1 against the whole
    module. Returns rank 0's and rank 2's records."""
    from vcvits_tpu_torch.parallel.mesh import make_mesh, shard_batch

    dp = make_mesh(2, 1, ranks=[0, 1])
    tp = make_mesh(1, 2, ranks=[2, 3])
    mine = dp if rank < 2 else tp
    out = {}
    name, fault = ("dp2", "sum_grads") if rank < 2 else ("tp2", "copy_to")
    out[name] = one_step(cfg_dict, shard_batch(batch, mine), draws, mine)
    with planted(fault):
        out[f"{name}_{fault}"] = one_step(cfg_dict, shard_batch(batch, mine), draws, mine)
    both = make_mesh(2, 2)
    out["dp2xtp2"] = one_step(cfg_dict, shard_batch(batch, both), draws, both)
    pair = make_mesh(1, 2, ranks=[0, 1])
    if rank < 2:
        out["wn"] = wn_under_tp(pair)
    return out if rank in (0, 2) else None


def wn_under_tp(mesh):
    """A 2-layer WN at hidden 256, kernel 5, with a speaker layer: every
    in_N / res_skip_N / cond_layer is sharded. Its forward, the input's and
    the parameters' gradients, and `kernel_forward` (K2's WaveNet mode on
    the gathered weights; the plain version on the CPU) against the same
    module unsharded."""
    from vcvits_tpu_torch.models.layers import init_weights
    from vcvits_tpu_torch.models.wavenet import WN
    from vcvits_tpu_torch.parallel.mesh import full_tensor, shard_params_tp

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 40, 256, generator=g)
    mask = torch.ones(2, 40, 1)
    mask[1, 30:] = 0
    spk = torch.randn(2, 16, generator=g)
    res = {}
    for sharded in (False, True):
        wn = init_weights(WN(256, 5, 1, 2, gin_channels=16), 5)
        with torch.no_grad():  # a non-zero last res_skip, a varied g
            for p in wn.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
        tp = shard_params_tp(wn, mesh) if sharded else {}
        xi = x.clone().requires_grad_(True)
        y = wn(xi, mask, spk)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        grads = {n: full_tensor(p.grad, tp.get(n), mesh) for n, p in wn.named_parameters()}
        with torch.no_grad():
            fused = wn.kernel_forward(x, mask, spk)
        res[sharded] = (y.detach(), xi.grad, grads, fused, sorted(tp))
    return res


def decoder_kinks(rank, n):
    """base.json's decoder widths (inter and gin 256, 512 channels: conv_pre
    and up_0 sharded), with its weight-norm gains x 3: the output and every
    gradient of a weighted sum of the output, one process against TP over
    ranks 0-1, and one process against itself with the input scaled by 1 +
    1e-7. Returns rank 0's {name: max |err| / max |g|} for both, and the
    outputs' max |err| / max |y|."""
    from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator
    from vcvits_tpu_torch.models.layers import init_weights
    from vcvits_tpu_torch.parallel.mesh import full_tensor, make_mesh, shard_params_tp

    mesh = make_mesh(1, 2)
    runs = {}
    for name, sharded, scale in (("one", False, 1.0), ("tp", True, 1.0),
                                 ("nudged", False, 1.0 + 1e-7)):
        dec = init_weights(HiFiGANGenerator(256, "1", (3,), ((1, 3),), (8, 8, 4, 2), 512,
                                            (16, 16, 4, 4), gin_channels=256), 3)
        with torch.no_grad():
            for k, p in dec.named_parameters():
                if k.endswith(".g"):
                    p.mul_(3.0)
        tp = shard_params_tp(dec, mesh) if sharded else {}
        gen = torch.Generator().manual_seed(1)
        x = (torch.randn(2, 8, 256, generator=gen) * scale).requires_grad_(True)
        y = dec(x, g=torch.randn(2, 256, generator=gen), fused_mrf=False)
        (y * torch.randn(y.shape, generator=torch.Generator().manual_seed(2))).sum().backward()
        grads = {k: full_tensor(p.grad, tp.get(k), mesh) for k, p in dec.named_parameters()}
        runs[name] = (y.detach(), {"input": x.grad, **grads})
    (y0, g0) = runs["one"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    out = {name: {k: rel(runs[name][1][k], g0[k]) for k in g0} for name in ("tp", "nudged")}
    out["y_tp"] = rel(runs["tp"][0], y0)
    return out if rank == 0 else None


def fit_layouts(rank, n, cfg_dict, workdir, store_dir):
    """A DP2 x TP2 Trainer.fit to 2 steps over 4 ranks; then, in fresh
    process groups of ranks 0-1, a resume at TP=1 (DP2) to 3 and at TP=2
    to 4. Each resumed state equals the checkpoint it came from."""
    _block_tensorboard()
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.parallel.dryrun import reinit
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager
    from vcvits_tpu_torch.train.trainer import Trainer

    cfg = Config.from_dict(cfg_dict)
    hub = HubertConfig(**TINY_HUBERT)
    rec = {}
    tr = Trainer(cfg, workdir=workdir, device="cpu", hubert_cfg=hub, model_parallel=2)
    rec["layout0"] = (tr.mesh.data, tr.mesh.model)
    rec["fit0"] = tr.fit(max_steps=2)
    import torch.distributed as dist

    dist.destroy_process_group()
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    if rank >= 2:
        return None
    for i, mp in enumerate((1, 2)):
        reinit(2, rank, os.path.join(store_dir, f"r{i}"), "gloo")
        tr = Trainer(cfg, workdir=workdir, device="cpu", hubert_cfg=hub, model_parallel=mp)
        saved = ckpt.restore()
        tr.resume_or_init()
        now = tr.train_step.state_dict()
        diff = max(float((now[side][k] - saved[side][k]).abs().max())
                   for side in ("gen", "disc") for k in saved[side])
        rec[f"resume_tp{mp}"] = {"layout": (tr.mesh.data, tr.mesh.model),
                                 "from": int(saved["step"]), "max_abs_diff": diff,
                                 "fit": tr.fit(max_steps=3 + i)}
    return rec if rank == 0 else None


def tts_step(rank, n, cfg_dict, batch, draws, n_vocab):
    """One data-parallel TTS step on this rank's rows with global draws ->
    (metrics, whole G and D gradients)."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.data.loader import to_device
    from vcvits_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vcvits_tpu_torch.train.tts_step import TTSStepDraws, TTSTrainStep

    mesh = make_mesh(n, 1)
    step = TTSTrainStep(Config.from_dict(cfg_dict), device="cpu", seed=0, n_vocab=n_vocab,
                        mesh=mesh)
    metrics = step(to_device(shard_batch(batch, mesh), "cpu"),
                   TTSStepDraws(**{k: torch.as_tensor(v) for k, v in draws.items()}))
    grads = {f"{s}.{k}": p.grad.clone() for s, m in (("g", step.gen), ("d", step.disc))
             for k, p in m.named_parameters() if p.grad is not None}
    return ({k: float(v) for k, v in metrics.items()}, grads) if rank == 0 else None


def cli_train(rank, n, argv):
    """cli.train.main under a process group (as under torchrun)."""
    _block_tensorboard()
    from vcvits_tpu_torch.cli import train as cli
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertConfig

    synthesizer.hubert_config_for = lambda channels: HubertConfig(**TINY_HUBERT)
    from vcvits_tpu_torch.train import trainer as trainer_mod

    built = []
    real = trainer_mod.Trainer

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    trainer_mod.Trainer = Recording
    try:
        cli.main(argv)
    finally:
        trainer_mod.Trainer = real
    tr = built[0]
    return {"layout": (tr.mesh.data, tr.mesh.model), "step": tr.train_step.step,
            "sharded": len(tr.train_step.g_tp) + len(tr.train_step.d_tp)}


def cli_train_tts(rank, n, argv):
    """cli.train_tts.main under a process group."""
    _block_tensorboard()
    from vcvits_tpu_torch.cli import train_tts as cli
    from vcvits_tpu_torch.train import tts_trainer

    built = []
    real = tts_trainer.TTSTrainer

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    tts_trainer.TTSTrainer = Recording
    try:
        cli.main(argv)
    finally:
        tts_trainer.TTSTrainer = real
    tr = built[0]
    return {"data": tr.mesh.data, "step": tr.train_step.step}


def global_draws(cfg_dict, b, t_spec, seed=11):
    """Global injected draws of one step: both forwards' eps and starts."""
    g = np.random.default_rng(seed)
    inter = cfg_dict["model"]["inter_channels"]
    seg = cfg_dict["train"]["segment_size"] // cfg_dict["data"]["hop_length"]
    return {"eps": g.standard_normal((b, t_spec, inter)).astype(np.float32),
            "ids_str": g.integers(0, t_spec - seg + 1, (b,)).astype(np.int32),
            "eps2": g.standard_normal((b, t_spec, inter)).astype(np.float32),
            "ids_str2": g.integers(0, t_spec - seg + 1, (b,)).astype(np.int32)}


def grad_sum_spans(rank, n):
    """The program spans `Mesh.sum_grads` opens under a profiler on an
    n-rank data group, with the gradient it leaves (rank 0)."""
    from torch.profiler import ProfilerActivity, profile

    from vcvits_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n, 1)
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank + 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mesh.sum_grads([p])
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("vcvits.")]
    return (names, p.grad.tolist()) if rank == 0 else None
