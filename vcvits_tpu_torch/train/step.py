"""The GAN train step: generator update, then discriminator update.

Counterpart of vcvits_tpu/train/step.py:make_train_step. One call of
`TrainStep` on a batch:

1. Frozen features: the 16 kHz source is smoothed (STFT -> iSTFT), the
   frozen HuBERT runs once on it and its features are shared by both
   generator forwards (`share_frozen_hubert`), and the 48 kHz target's
   spectrogram and log-mel come from ops/stft_mel.py (kernel K3, one
   launch).
2. Generator: the training forward (posterior + flow, whose WN gates are
   K5 with its backward; the decoder's differentiable path), both
   discriminators on the matching target segment, and
   total = s_gen + s_fm + p_gen + p_fm + c_mel * mel-L1 + c_kl * KL.
   Backward, global grad norm, AdamW step.
3. Discriminator: with `d_recompute_forward` (the default) the generator
   forward runs again with the current weights and fresh draws, no
   gradient; then the LS-GAN loss of both discriminators, backward, grad
   norm, AdamW step.

`cfg.train.remat_policy` trades memory for recomputation as JAX's
`jax.checkpoint` does around the same two functions: the generator's
training forward and the MPD + MSD forward run under
`torch.utils.checkpoint` ("nothing": the whole forward is recomputed in the
backward; "dots": the outputs of matrix products and convolutions are
kept, the rest recomputed). The recompute replays the first run's draws
(`checkpointed`), so each policy computes what "none" computes and leaves
the step's generators where "none" leaves them. The D half's recomputed
generator forward runs without gradient and is not wrapped, as in JAX.

`dtype` is the compute dtype (`make_train_step(cfg, dtype=...)`): float32,
or bfloat16 as `"fp16_run": true` selects. Parameters, gradients, AdamW
and every loss stay float32; the casts are JAX's: the targets come from
K3 on the float32 waveform and only `y_spec` goes to the compute dtype,
as do the source wave and the shared HuBERT features (HuBERT runs in it);
the generated slice's mel is taken of `o` in float32; the discriminators
see the target segment in the compute dtype.

With `accumulate_grad_batches` k > 1 (optax.MultiSteps in JAX) each call
is a mini-step: the grad norms are this mini-batch's, its gradients go
into a running mean (`train/state.GradAccumulator`), and only the k-th
mini-step clips the mean and steps AdamW, at the learning rate of the
number of real updates so far; the logged `learning_rate` is that of the
mini-step count. On mini-steps 1 .. k-1 the parameters do not move, and
the D half's recompute runs the unmoved generator.

Each call is a program span "vcvits.train.step" (utils/profiling.py), with
one span a section: "vcvits.train.features", "g_forward", "g_losses",
"g_backward", "g_optimizer" (grad norm, clip, AdamW), "d_recompute",
"d_forward", "d_backward", "d_optimizer" (`_Sections`, which also times
them with CUDA events under `timings=`).

Every random draw is explicit: `StepDraws` injects the posterior noise and
the segment starts of either forward (tests inject JAX's), and what is not
injected comes from the step's generators. The metrics dict has the JAX
step's keys, as 0-dim float32 tensors.

On a `Mesh` (parallel/mesh.py) of data x model ranks, each rank's batch
holds its rows of the global batch (`cfg.train.batch_size`), and every
loss is the global batch's, as under JAX's single controller: a rank's
means count for its share of the rows, the KL divides by the global mask
sum, the gradients are summed over the data group after each backward
(and before an accumulator folds them), and the metrics are summed there
too. Every rank draws the global batch's noise, segment starts and
dropout masks from the shared seeded generators and keeps its rows, so a
data-parallel step is the one-process step on the same batch and seed;
injected `StepDraws` are the global batch's. The layers `tp_spec` marks
are sharded over the model group (their AdamW state follows them), the
grad norm counts a sharded gradient's squares once over that group, and
`state_dict` / `load_state_dict` carry whole tensors, so a checkpoint
restores into any layout.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.dsp.spectrogram import mel_spectrogram
from vcvits_tpu_torch.models.content_encoder import HUBERT_PAD
from vcvits_tpu_torch.models.discriminators import Discriminators
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.layers import dropout_rows, init_weights
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC
from vcvits_tpu_torch.ops.stft_mel import spectrogram_mel
from vcvits_tpu_torch.parallel.mesh import (
    Mesh, full_tensor, grad_sq_norm, local_tensor, shard_params_tp)
from vcvits_tpu_torch.train.audio_pipeline import smooth_source
from vcvits_tpu_torch.train.losses import (
    discriminator_loss, feature_loss, generator_loss, kl_loss)
from vcvits_tpu_torch.train.state import (
    GradAccumulator, accumulate_and_step, exponential_epoch_schedule, make_optimizer,
    trainable_parameters)
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.masking import segment_starts, slice_segments
from vcvits_tpu_torch.utils.profiling import span

Batch = Mapping[str, torch.Tensor]

# metrics that are the same on every rank (the others are summed over the
# data group)
GLOBAL_METRICS = ("learning_rate", "grad_norm_g", "grad_norm_d")


@dataclass
class StepDraws:
    """Injected draws of one step; None means draw from the step's generator.
    eps: posterior noise [B, T_spec, inter]; ids_str: segment starts [B] in
    spectrogram frames. `*2` are those of the D-step's recomputed forward."""

    eps: Optional[torch.Tensor] = None
    ids_str: Optional[torch.Tensor] = None
    eps2: Optional[torch.Tensor] = None
    ids_str2: Optional[torch.Tensor] = None


def check_step_config(cfg: Config, dtype: torch.dtype) -> None:
    """Refuse a compute dtype other than float32 or bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")


REMAT_POLICIES = ("none", "dots", "nothing")
# the ops whose outputs "dots" keeps (jax.checkpoint_policies.checkpoint_dots:
# dot_general and convolution)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
                   torch.ops.aten.convolution.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable[[], object], policy: str,
                 generators: Sequence[torch.Generator] = ()) -> object:
    """fn() under torch.utils.checkpoint with the remat `policy` ("dots" or
    "nothing"). The recompute in the backward replays the first run's
    draws: each of `generators` is set back to its state at entry before
    it, and after it to the state it had when the recompute began, so what
    was drawn between the forward and the backward stays drawn and the
    draws that follow are those of an unwrapped call. `checkpoint`'s own
    `preserve_rng_state` restores only the default generators. What else
    fn reads besides its tensors, such as the `dropout_rows` context, fn
    must set up itself: the recompute runs inside the backward."""
    entry = [g.get_state() for g in generators]
    ran = []

    def run():
        if not ran:
            ran.append(True)
            return fn()
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, entry):
            g.set_state(state)
        try:
            return fn()
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if policy == "dots" else noop_context_fn)
    return checkpoint(run, use_reentrant=False, context_fn=context_fn)


def _grad_norm(params, sharded: Sequence = (), mesh: Optional[Mesh] = None) -> torch.Tensor:
    """optax.global_norm of the gradients (a missing gradient counts 0),
    summed in float64: a float32 sum over the discriminators' 50M squares
    drifts by 1e-4. Under tensor parallelism the `sharded` parameters'
    squares are summed over the model group once."""
    if mesh is not None and mesh.model > 1:
        return torch.sqrt(grad_sq_norm(params, sharded, mesh)).float()
    norms = [torch.linalg.vector_norm(p.grad, dtype=torch.float64)
             for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class _Sections:
    """The step's sections, one after another: `begin(name, key)` ends the
    open section and starts `name`. Each is a program span
    "vcvits.train.<name>" (utils/profiling.py), inside "vcvits.train.step",
    which the `with` block opens and closes. When `out` is a dict (and the
    step runs on the card), CUDA events at the section boundaries give
    each section's device ms, stream time with its gaps, added into
    `out[key]` by `done()`."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
        self.out = out if device.type == "cuda" else None
        self.marks = []
        self.open: list = []    # the open spans, outermost first
        self.key: Optional[str] = None
        self._mark("start")

    def __enter__(self) -> "_Sections":
        self._push("train.step")
        return self

    def __exit__(self, *exc) -> bool:
        while self.open:  # on an exception too
            self.open.pop().__exit__(None, None, None)
        return False

    def _push(self, name: str) -> None:
        sp = span(name)
        sp.__enter__()
        self.open.append(sp)

    def _mark(self, key: str) -> None:
        if self.out is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((key, ev))

    def _end(self) -> None:
        if self.key is not None:
            self._mark(self.key)
            self.open.pop().__exit__(None, None, None)
            self.key = None

    def begin(self, name: str, key: str) -> None:
        """End the open section; start section `name`, timed under `key`."""
        self._end()
        self._push("train." + name)
        self.key = key

    def done(self) -> None:
        """End the last section; add each section's device ms into `out`."""
        self._end()
        if self.out is None:
            return
        self.marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            self.out[name] = self.out.get(name, 0.0) + a.elapsed_time(b)


class GANStep:
    """What a GAN train step holds beside its generator and its step
    function: the discriminators, both AdamWs and gradient accumulators,
    the schedule, the step counts, the generators of its draws, and the
    checkpoint layout (`state_dict` / `load_state_dict`). `TrainStep` (the
    conversion model) and train/tts_step.py's `TTSTrainStep` build on it.

    The learning rate decays once per epoch of `steps_per_epoch` steps; the
    config's `steps_per_epoch` overrides it, and 1000 is used where neither
    is set (`train/state.resolve_steps_per_epoch`). `dtype` is the compute
    dtype (float32 or bfloat16); `cfg.trainer.accumulate_grad_batches`
    mini-steps make an update. `step` counts calls (mini-steps, JAX's
    `state.step`), `updates` the AdamW steps taken, and `mini_step` the
    calls since the last update. `mesh` is the data x model layout (one
    process by default; see the module docstring)."""

    def __init__(self, cfg: Config, device: torch.device, dtype: torch.dtype,
                 gen: torch.nn.Module, g_params, d_state: Optional[Mapping[str, torch.Tensor]],
                 seed: int, steps_per_epoch: Optional[int], mesh: Optional[Mesh] = None):
        """`gen` (built, on `device`) with its trainable `g_params`; the
        discriminators from `d_state`, or seeded with seed + 1. Both are
        built whole and then sharded over the mesh's model group."""
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        self.mesh = mesh or Mesh()
        self.gen = gen
        self.disc = Discriminators.from_config(cfg, dtype=dtype)
        if d_state is not None:
            self.disc.load_state_dict(d_state)
        else:
            init_weights(self.disc, seed + 1)
        self.disc.to(device)
        self.gen.train()
        self.disc.train()
        # {parameter name: sharded axis} of each model (empty at model = 1)
        self.g_tp = shard_params_tp(self.gen, self.mesh)
        self.d_tp = shard_params_tp(self.disc, self.mesh)
        self.g_params = list(g_params)
        self.d_params = list(self.disc.parameters())
        self.sharded = [p for m, tp in ((self.gen, self.g_tp), (self.disc, self.d_tp))
                        for n, p in m.named_parameters() if n in tp]
        self.g_opt = make_optimizer(self.g_params, cfg)
        self.d_opt = make_optimizer(self.d_params, cfg)
        k = cfg.trainer.accumulate_grad_batches
        self.g_acc = GradAccumulator(self.g_params, k)
        self.d_acc = GradAccumulator(self.d_params, k)
        self.set_steps_per_epoch(steps_per_epoch)
        self.step = 0
        self.updates = 0
        self.mini_step = 0
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.dropout_generator = torch.Generator(device=device).manual_seed(seed + 1)

    def set_steps_per_epoch(self, steps_per_epoch: Optional[int]) -> None:
        """The schedule's epoch length: `steps_per_epoch` where the config
        sets none (the Trainer passes its loader's length)."""
        self.schedule = exponential_epoch_schedule(self.cfg, steps_per_epoch)

    def state_dict(self) -> Dict[str, object]:
        """The train state, as a checkpoint holds it: {"step", "gen" and
        "disc" (state dicts), "g_opt" and "d_opt" (AdamW's per-parameter
        state, keyed by parameter name), "accum" (the accumulator:
        "mini_step", "updates", and G's and D's running-mean gradients "g"
        and "d" by parameter name, empty when k == 1)}. Tensors are the
        live ones; under tensor parallelism a sharded one is gathered whole
        (a collective: every rank of the model group calls this)."""
        gt, dt = self.g_tp, self.d_tp
        return {"step": self.step,
                "gen": self._whole(self.gen.state_dict(), gt),
                "disc": self._whole(self.disc.state_dict(), dt),
                "g_opt": self._opt_state(self.gen, self.g_opt, gt),
                "d_opt": self._opt_state(self.disc, self.d_opt, dt),
                "accum": {"mini_step": self.mini_step, "updates": self.updates,
                          "g": self._whole(self.g_acc.state_dict(self._names(self.gen)), gt),
                          "d": self._whole(self.d_acc.state_dict(self._names(self.disc)), dt)}}

    def load_state_dict(self, state: Mapping[str, object]) -> None:
        """Load a `state_dict()`-shaped state of whole tensors, each copied
        to the step's device (this rank's slice of a sharded one); a
        parameter missing from an optimizer's state starts fresh. A state
        without "accum" (written before accumulation was ported, always
        with k == 1, so one update a step) starts a fresh accumulator at
        `updates` = `step`."""
        gt, dt = self.g_tp, self.d_tp
        self.step = int(state["step"])
        self.gen.load_state_dict(self._local(state["gen"], gt))
        self.disc.load_state_dict(self._local(state["disc"], dt))
        for module, opt, key, tp in ((self.gen, self.g_opt, "g_opt", gt),
                                     (self.disc, self.d_opt, "d_opt", dt)):
            opt.state.clear()
            named = dict(module.named_parameters())
            for name, moments in state[key].items():
                p = named[name]
                opt.state[p] = {k: (v.detach().to("cpu", copy=True) if k == "step" else
                                    local_tensor(v.detach(), tp.get(name), self.mesh)
                                    .to(p.device, copy=True))
                                for k, v in moments.items()}
        accum = state.get("accum") or {"mini_step": 0, "updates": self.step, "g": {}, "d": {}}
        self.mini_step = int(accum["mini_step"]) % self.g_acc.k
        self.updates = int(accum["updates"])
        self.g_acc.load_state_dict(self._local(accum["g"], gt), self._names(self.gen))
        self.d_acc.load_state_dict(self._local(accum["d"], dt), self._names(self.disc))

    def _whole(self, tensors: Mapping[str, torch.Tensor], tp: Mapping[str, int]) -> Dict:
        return {n: full_tensor(v, tp.get(n), self.mesh) for n, v in tensors.items()}

    def _local(self, tensors: Mapping[str, torch.Tensor], tp: Mapping[str, int]) -> Dict:
        return {n: local_tensor(v, tp.get(n), self.mesh) for n, v in tensors.items()}

    @staticmethod
    def _names(module: torch.nn.Module) -> Dict[int, str]:
        return {id(p): name for name, p in module.named_parameters()}

    def _opt_state(self, module: torch.nn.Module, opt: torch.optim.Optimizer,
                   tp: Mapping[str, int]) -> Dict[str, Dict]:
        return {name: {k: v if k == "step" else full_tensor(v, tp.get(name), self.mesh)
                       for k, v in opt.state[p].items()}
                for name, p in module.named_parameters() if p in opt.state and opt.state[p]}

    # ------------------------------------------------------- data parallelism
    def _rows(self, b_local: int):
        """(lo, hi, B): this rank's rows of the global batch of B."""
        lo = self.mesh.data_rank * b_local
        return lo, lo + b_local, b_local * self.mesh.data

    def _share(self, loss: torch.Tensor) -> torch.Tensor:
        """A mean over this rank's rows as its share of the global mean."""
        return loss if self.mesh.data == 1 else loss / self.mesh.data

    def _mask_sum(self, den: torch.Tensor) -> torch.Tensor:
        return self.mesh.sum_data(den.float()).to(den.dtype)

    def _dropout_rows(self, b_local: int):
        """Dropout masks drawn for the global batch, this rank's rows kept."""
        if self.mesh.data == 1:
            return contextlib.nullcontext()
        return dropout_rows(*self._rows(b_local))

    def _global_noise(self, given: Optional[torch.Tensor], b_local: int, shape,
                      dtype: torch.dtype) -> Optional[torch.Tensor]:
        """This rank's rows of a normal draw for the global batch (`shape`
        is a row's), or of the injected global `given`; None at data = 1
        with nothing injected (the model draws itself)."""
        if self.mesh.data == 1:
            return given
        lo, hi, total = self._rows(b_local)
        if given is None:
            given = torch.randn((total, *shape), generator=self.generator, device=self.device,
                                dtype=dtype)
        return given[lo:hi]

    def _global_starts(self, given: Optional[torch.Tensor], lengths: torch.Tensor,
                       segment: int) -> Optional[torch.Tensor]:
        """This rank's segment starts: its rows of the global batch's
        uniform draws (or of the injected global starts)."""
        if self.mesh.data == 1:
            return given
        lo, hi, total = self._rows(lengths.shape[0])
        if given is not None:
            return given[lo:hi]
        u = torch.rand(total, generator=self.generator, device=self.device)[lo:hi]
        return segment_starts(u, lengths, segment)

    def _sum_and_norm(self, params) -> torch.Tensor:
        """The gradients summed over the data group, then their global norm."""
        self.mesh.sum_grads(params)
        return _grad_norm(params, self.sharded, self.mesh)

    def _adversarial_g(self, outputs):
        """The generator's adversarial loss from the discriminators' outputs
        on [target; generated] -> (s_gen + s_fm + p_gen + p_fm, its terms by
        metric name); the MSD's terms only where it is there."""
        (_, p_lg, p_fr, p_fg), msd = outputs
        share = self._share
        terms = {"loss/g/p_fm": share(feature_loss(p_fr, p_fg)),
                 "loss/g/p_gen": share(generator_loss(p_lg)[0])}
        loss = terms["loss/g/p_gen"] + terms["loss/g/p_fm"]
        if msd is not None:
            _, s_lg, s_fr, s_fg = msd
            terms["loss/g/s_fm"] = share(feature_loss(s_fr, s_fg))
            terms["loss/g/s_gen"] = share(generator_loss(s_lg)[0])
            loss = (terms["loss/g/s_gen"] + terms["loss/g/s_fm"]) + loss
        return loss, terms

    def _adversarial_d(self, outputs, per_head: bool = False):
        """The discriminators' LS-GAN loss -> (loss, {"loss/d/p", "loss/d/s"}
        and, with `per_head`, each head's real and generated terms); the
        MSD's only where it is there."""
        (p_lr, p_lg, _, _), msd = outputs
        share = self._share
        loss_p, p_r, p_g = discriminator_loss(p_lr, p_lg)
        loss = share(loss_p)
        metrics = {"loss/d/p": loss}
        heads = [("d_p_r", p_r), ("d_p_g", p_g)]
        if msd is not None:
            loss_s, s_r, s_g = discriminator_loss(msd[0], msd[1])
            metrics["loss/d/s"] = share(loss_s)
            loss = loss + metrics["loss/d/s"]
            heads += [("d_s_r", s_r), ("d_s_g", s_g)]
        if per_head:
            for name, terms in heads:
                metrics.update({f"loss/{name}/{i}": share(v) for i, v in enumerate(terms)})
        return loss, metrics

    def _target_segment(self, batch: Batch, ids: torch.Tensor) -> torch.Tensor:
        """The target's segment at `ids`, [B, segment, 1] in the compute dtype."""
        hop = self.cfg.data.hop_length
        return slice_segments(batch["y_wav"][:, :, None], ids * hop,
                              self.cfg.train.segment_size).to(self.dtype)

    def _mel_of(self, wav: torch.Tensor) -> torch.Tensor:
        d = self.cfg.data
        return mel_spectrogram(wav, d.filter_length, d.n_mel_channels, d.target_sampling_rate,
                               d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)

    def _advance(self) -> None:
        """Count the mini-step just taken (and the update, on the k-th)."""
        if self.mini_step == self.g_acc.k - 1:
            self.updates += 1
        self.mini_step = (self.mini_step + 1) % self.g_acc.k
        self.step += 1

    def _set_lr(self, lr: float) -> None:
        for opt in (self.g_opt, self.d_opt):
            for group in opt.param_groups:
                group["lr"] = lr


class TrainStep(GANStep):
    """The conversion model's generator (SynthesizerSVC, HuBERT frozen) on
    a `GANStep`, and the step function.

    Builds on `device` ("cuda" by default; raises when no GPU is present
    unless device="cpu"). Weights come from the seeded initialisers, or
    from `g_state` / `d_state` (for example params_from_jax /
    disc_params_from_jax of the JAX package's trees)."""

    def __init__(self, cfg: Config, device="cuda",
                 hubert_cfg: Optional[HubertConfig] = None, seed: int = 0,
                 g_state: Optional[Mapping[str, torch.Tensor]] = None,
                 d_state: Optional[Mapping[str, torch.Tensor]] = None,
                 steps_per_epoch: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None):
        device = resolve_device(device)
        check_step_config(cfg, dtype)
        if cfg.train.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.train.remat_policy!r}")
        gen = SynthesizerSVC.from_config(cfg, dtype=dtype, device=device,
                                         seed=seed if g_state is None else None,
                                         hubert_cfg=hubert_cfg)
        if g_state is not None:
            gen.load_state_dict(g_state)
        for p in gen.enc_p.hubert.parameters():
            p.requires_grad_(False)
        super().__init__(cfg, device, dtype, gen, trainable_parameters(gen), d_state, seed,
                         steps_per_epoch, mesh)

    def _features(self, batch: Batch):
        """(source wav, shared HuBERT features or None, y_spec, y_mel), frozen;
        all but y_mel in the compute dtype."""
        d, t, dt = self.cfg.data, self.cfg.train, self.dtype
        with torch.no_grad():
            hub = batch.get("hubert_features")
            if hub is not None:
                x_wav = batch["x_wav"]
            else:
                x_wav = smooth_source(batch["x_wav"], d.filter_length, d.hop_length,
                                      d.win_length)
                if t.share_frozen_hubert:
                    hub = self.gen.enc_p.hubert(F.pad(x_wav.to(dt), (HUBERT_PAD, HUBERT_PAD)))
            y_spec, y_mel = spectrogram_mel(batch["y_wav"], d.filter_length, d.n_mel_channels,
                                            d.target_sampling_rate, d.hop_length, d.win_length,
                                            d.mel_fmin, d.mel_fmax)
        return x_wav.to(dt), None if hub is None else hub.to(dt), y_spec.to(dt), y_mel

    def _gen_forward(self, batch: Batch, x_wav, hub, y_spec, eps, ids_str):
        """The training forward; on a data mesh with this rank's rows of the
        global batch's draws (eps, then the segment starts, as the model
        draws them) and dropout masks."""
        b = x_wav.shape[0]
        y_lengths = batch["y_wav_lengths"] // self.cfg.data.hop_length
        eps = self._global_noise(eps, b, (y_spec.shape[1], self.cfg.model.inter_channels),
                                 self.dtype)
        ids_str = self._global_starts(ids_str, y_lengths, self.gen.segment_size)
        with self._dropout_rows(b):
            return self.gen(x_wav, batch["x_wav_lengths"], batch["x_pitch"], y_spec, y_lengths,
                            batch.get("sid"), deterministic=False, hubert_features=hub,
                            eps=eps, ids_str=ids_str, generator=self.generator,
                            dropout_generator=self.dropout_generator)

    def _remat(self, fn: Callable[[], object], draws: bool = False) -> object:
        """fn() under the config's remat policy; `draws`: fn draws from the
        step's generators (the generator forward), which a recompute replays."""
        policy = self.cfg.train.remat_policy
        if policy == "none":
            return fn()
        return checkpointed(fn, policy,
                            (self.generator, self.dropout_generator) if draws else ())

    def __call__(self, batch: Batch, draws: Optional[StepDraws] = None,
                 timings: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
        """One step on a batch of padded tensors on the step's device:
        x_wav [B, Tx] 16 kHz, x_wav_lengths [B], x_pitch [B, Tx//320],
        y_wav [B, Ty] 48 kHz, y_wav_lengths [B], sid [B] (on a data mesh,
        this rank's rows). With `timings` (a dict) on the card, each
        section's device ms is added to it."""
        draws = draws or StepDraws()
        with _Sections(timings, self.device) as sections:
            # AdamW's schedule counts real updates, the logged rate mini-steps
            self._set_lr(self.schedule(self.updates))
            sections.begin("features", "features (smooth_source, HuBERT, K3)")
            feats = self._features(batch)
            g_metrics, o, ids = self._generator_step(batch, feats, draws, sections)
            d_metrics = self._discriminator_step(batch, feats, o, ids, draws, sections)
            sections.done()
        metrics = {"learning_rate": torch.tensor(self.schedule(self.step), dtype=torch.float32),
                   **g_metrics, **d_metrics}
        self._advance()
        metrics = self.mesh.sum_metrics(metrics, keep=GLOBAL_METRICS)
        return {k: v.detach() for k, v in metrics.items()}

    def _generator_step(self, batch: Batch, feats, draws: StepDraws, sections: _Sections):
        """Forward, losses, backward and AdamW step of the generator (the
        discriminators get no gradient) -> (metrics, output wave, segment
        starts)."""
        cfg, t = self.cfg, self.cfg.train
        x_wav, hub, y_spec, y_mel = feats
        self.disc.requires_grad_(False)
        sections.begin("g_forward", "G forward")
        o, ids, _, y_mask, (_, z_p, m_p, logs_p, _, logs_q) = self._remat(
            lambda: self._gen_forward(batch, x_wav, hub, y_spec, draws.eps, draws.ids_str),
            draws=True)
        sections.begin("g_losses", "G losses (MPD + MSD forward, mel, KL)")
        y_seg = self._target_segment(batch, ids)
        adv, adv_metrics = self._adversarial_g(self._remat(lambda: self.disc(y_seg, o)))
        share = self._share
        o_mel = self._mel_of(o[:, :, 0].float())
        y_mel_slice = slice_segments(y_mel, ids, t.segment_size // cfg.data.hop_length)
        loss_mel = share(torch.mean(torch.abs(o_mel - y_mel_slice))) * t.c_mel
        loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, y_mask,
                          self._mask_sum if self.mesh.data > 1 else None) * t.c_kl
        loss_g = adv + loss_mel + loss_kl
        sections.begin("g_backward", "G backward")
        self.g_opt.zero_grad(set_to_none=True)
        loss_g.backward()
        sections.begin("g_optimizer", "G grad norm + AdamW")
        self.disc.requires_grad_(True)
        grad_norm_g = self._sum_and_norm(self.g_params)
        accumulate_and_step(self.g_opt, self.g_acc, self.mini_step, t.grad_clip)
        metrics = {"loss/g/total": loss_g, "grad_norm_g": grad_norm_g, **adv_metrics,
                   "loss/g/mel": loss_mel, "loss/g/kl": loss_kl}
        return metrics, o, ids

    def _discriminator_step(self, batch: Batch, feats, o: Optional[torch.Tensor],
                            ids: Optional[torch.Tensor], draws: StepDraws,
                            sections: _Sections) -> Dict[str, torch.Tensor]:
        """LS-GAN loss, backward and AdamW step of the discriminators, on the
        generator recomputed with its current weights (`d_recompute_forward`)
        or on the G step's `o` and `ids` -> metrics."""
        t = self.cfg.train
        x_wav, hub, y_spec, _ = feats
        sections.begin("d_recompute", "D-step generator recompute")
        with torch.no_grad():
            if t.d_recompute_forward:
                o2, ids2 = self._gen_forward(batch, x_wav, hub, y_spec, draws.eps2,
                                             draws.ids_str2)[:2]
            else:
                o2, ids2 = o.detach(), ids
        sections.begin("d_forward", "D forward + loss")
        y_seg2 = self._target_segment(batch, ids2)
        loss_d, metrics = self._adversarial_d(self._remat(lambda: self.disc(y_seg2, o2)),
                                              per_head=True)
        sections.begin("d_backward", "D backward")
        self.d_opt.zero_grad(set_to_none=True)
        loss_d.backward()
        sections.begin("d_optimizer", "D grad norm + AdamW")
        grad_norm_d = self._sum_and_norm(self.d_params)
        accumulate_and_step(self.d_opt, self.d_acc, self.mini_step, t.grad_clip)
        return {"loss/d/total": loss_d, "grad_norm_d": grad_norm_d, **metrics}
