"""What the conversion loops share: the system under test built from a
configuration file and the run's seed, the sample of requests the check
compares, and the check itself against the plain reference.

The program is vcvits_tpu_torch's `VoiceConverter`, built with no weights
of its own and loaded with the benchmark's draw (benchmark/weights.py).
The check draws the same weights again from the seed once the program is
freed and runs benchmark/reference/vc.py on each sampled request at the
shape the timed path ran it: its source padded as its batch was padded,
its row of its batch's noise draw, drawn again from the seed and the
batch's shape, as the program draws it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import vc as ref

# the batch's noise seed, the same for every request of a run, drawn from
# the run's seed (a client that passes no seed sends 0; one seed a run
# keeps every request's draw a row of one reproducible draw)
NOISE_SEED_SALT = 0x5EED


@dataclass
class Case:
    """One request as the timed path ran it."""
    wav: np.ndarray        # the padded source as its batch row held it
    true_len: int
    pitch: np.ndarray      # [len(wav) // 320], zero past the request's own frames
    speaker: int
    batch: int             # rows of its batch's draw
    row: int               # its row
    noise_seed: int
    noise_scale: float
    out: Optional[np.ndarray]  # what the program returned (None: never came)


def model_blocks(ctx: harness.Context) -> Tuple[dict, dict, ref.Hubert]:
    cfg = ctx.config["config"]
    return cfg["model"], cfg["data"], ref.hubert_for(cfg["model"], ctx.config.get("hubert"))


def port_hubert_cfg(ctx: harness.Context):
    """The program's HubertConfig where the configuration file overrides
    HuBERT's sizes (the CPU tests' small model), else None: the program
    then chooses it by hubert_channels, as the reference does."""
    from vcvits_tpu_torch.models.hubert import HubertConfig

    if not ctx.config.get("hubert"):
        return None
    _, _, hub = model_blocks(ctx)
    return HubertConfig(conv_layers=hub.conv_layers, hidden_size=hub.hidden,
                        num_layers=hub.layers, num_heads=hub.heads, intermediate_size=hub.ffn,
                        pos_conv_kernel=hub.pos_k, pos_conv_groups=hub.pos_groups)


def build_converter(ctx: harness.Context):
    """The program's VoiceConverter on ctx.device with the seed's weights."""
    from vcvits_tpu_torch.config import Config
    from vcvits_tpu_torch.infer import VoiceConverter

    cfg = Config.from_dict(ctx.config["config"])
    model, data, hub = model_blocks(ctx)
    w = weights.draw(model, data, hub, ctx.seed, ctx.device)
    vc = VoiceConverter(cfg, state_dict=w, dtype=torch.float32, device=ctx.device,
                        hubert_cfg=port_hubert_cfg(ctx))
    del w
    return vc


def noise_seed(seed: int) -> int:
    return int(np.random.default_rng([seed, NOISE_SEED_SALT]).integers(0, 2 ** 31 - 1))


def sample_indices(n: int, k: int, secs: np.ndarray, seed: int) -> List[int]:
    """k request indices drawn from the seed, the longest request among
    them."""
    if n == 0:
        return []
    rng = np.random.default_rng([seed, 0xC4EC])
    longest = int(np.argmax(secs))
    others = [i for i in rng.permutation(n).tolist() if i != longest]
    return sorted([longest] + others[:max(k - 1, 0)])


def reference_outputs(ctx: harness.Context, cases: List[Case],
                      tf32: bool = False) -> List[np.ndarray]:
    """The reference's valid samples for each case; with `tf32` the control
    (the reference with every product's inputs rounded to TF32)."""
    model, data, hub = model_blocks(ctx)
    dev = ctx.device
    w = weights.draw(model, data, hub, ctx.seed, dev)
    outs = []
    for c in cases:
        t_out = int(round(len(c.wav) * ref.LENGTH_SCALE))
        eps = torch.randn((c.batch, t_out, model["inter_channels"]), device=dev,
                          dtype=torch.float32,
                          generator=torch.Generator(device=dev).manual_seed(c.noise_seed))
        o, y_len = ref.infer(
            w, model, hub, torch.from_numpy(c.wav)[None].to(dev),
            torch.tensor([c.true_len], device=dev), torch.from_numpy(c.pitch)[None].to(dev),
            torch.tensor([c.speaker], device=dev), eps[c.row:c.row + 1], c.noise_scale,
            tf32=tf32)
        outs.append(o[0, :int(y_len[0]) * data["hop_length"]].cpu().numpy())
        del eps, o
    del w
    return outs


def errors(outs: List[Optional[np.ndarray]], refs: List[np.ndarray]) -> List[Optional[float]]:
    """Per case ||out - ref|| / ||ref||; None where the output never came or
    has another length."""
    return [None if o is None or len(o) != len(r) else harness.rel_err(o, r)
            for o, r in zip(outs, refs)]


def numbers(ctx: harness.Context, cases: List[Case], control: bool = False):
    """({compared name: number}, notes) of the sampled cases: the widest
    relative error of an answer against the reference, and how many answers
    never came or came at another length. With `control` the reference in
    TF32 stands in the program's place on the same cases."""
    refs = reference_outputs(ctx, cases)
    outs = reference_outputs(ctx, cases, tf32=True) if control else [c.out for c in cases]
    errs = errors(outs, refs)
    worst = max((e for e in errs if e is not None), default=math.inf)
    return ({"wave_rel_err": worst if math.isfinite(worst) else 1e30,
             "answers_missing_or_misshapen": sum(e is None for e in errs)},
            {"checked": len(cases), "wave_rel_err_each": errs})
