"""Optimizers and the learning-rate schedule of the GAN train step.

Counterpart of vcvits_tpu/train/state.py: AdamW (betas and eps from the
config, weight decay 0.01) for the generator and for the discriminator
pair, the same update as optax `adamw`; lr = lr0 * lr_decay^epoch, stepped
per epoch of `steps_per_epoch` steps. The frozen HuBERT is left out of the
generator's optimizer (the JAX package masks its subtree out of optax).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from vcvits_tpu_torch.config import Config


def resolve_steps_per_epoch(cfg: Config, steps_per_epoch: Optional[int] = None) -> int:
    """cfg.train.steps_per_epoch, else the loader's value, else 1000."""
    if cfg.train.steps_per_epoch is not None:
        return max(int(cfg.train.steps_per_epoch), 1)
    if steps_per_epoch is not None:
        return max(int(steps_per_epoch), 1)
    return 1000


def exponential_epoch_schedule(cfg: Config, steps_per_epoch: Optional[int] = None
                               ) -> Callable[[int], float]:
    """step -> lr0 * lr_decay ** (step // steps_per_epoch), in float32 as
    the JAX schedule computes it."""
    lr0, gamma = cfg.train.learning_rate, cfg.train.lr_decay
    spe = resolve_steps_per_epoch(cfg, steps_per_epoch)

    def schedule(step: int) -> float:
        epoch = torch.tensor(float(step // spe), dtype=torch.float32)
        return float(torch.tensor(lr0, dtype=torch.float32)
                     * torch.pow(torch.tensor(gamma, dtype=torch.float32), epoch))

    return schedule


def is_frozen(name: str) -> bool:
    """The frozen HuBERT's parameters (any `hubert` path component)."""
    return "hubert" in name.split(".")


def trainable_parameters(model: nn.Module, freeze_hubert: bool = True) -> Iterable[nn.Parameter]:
    return [p for n, p in model.named_parameters() if not (freeze_hubert and is_frozen(n))]


def make_optimizer(params: Iterable[nn.Parameter], cfg: Config) -> torch.optim.AdamW:
    if cfg.trainer.accumulate_grad_batches > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    t = cfg.train
    return torch.optim.AdamW(params, lr=t.learning_rate, betas=tuple(t.betas), eps=t.eps,
                             weight_decay=0.01)
