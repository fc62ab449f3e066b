"""Optimizers and the learning-rate schedule of the GAN train step.

Counterpart of vcvits_tpu/train/state.py: AdamW (betas and eps from the
config, weight decay 0.01) for the generator and for the discriminator
pair, the same update as optax `adamw`; lr = lr0 * lr_decay^epoch, stepped
per epoch of `steps_per_epoch` steps. The frozen HuBERT is left out of the
generator's optimizer (the JAX package masks its subtree out of optax).

With `accumulate_grad_batches` k > 1 the JAX package wraps the optimizer in
`optax.MultiSteps(chain(clip?, adamw(schedule)), k)`; `GradAccumulator`
is the port's counterpart of its gradient side (see its docstring for the
two step counts this implies).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional

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
    """AdamW over `params`. On the card it is fused (one multi-tensor
    kernel updates every parameter), with its learning rate a float32
    tensor beside the parameters (the step fills it) and its step counts
    there too, so a CUDA graph replays its update (train/graphs.py).
    `capturable` is set only because torch's capture check reads it; the
    fused update ignores it."""
    t = cfg.train
    params = list(params)
    kw = dict(betas=tuple(t.betas), eps=t.eps, weight_decay=0.01)
    if params and params[0].device.type == "cuda":
        lr = torch.tensor(t.learning_rate, dtype=torch.float32, device=params[0].device)
        return torch.optim.AdamW(params, lr=lr, fused=True, capturable=True, **kw)
    return torch.optim.AdamW(params, lr=t.learning_rate, **kw)


class GradAccumulator:
    """The gradient side of `optax.MultiSteps(opt, k)` for one parameter
    list: the running mean of k mini-steps' gradients, float32, kept beside
    the parameters (`mean`, empty when k == 1).

    `fold(mini_step)` takes each parameter's `.grad` (a missing one counts
    0) into the mean as optax does, `mean + (g - mean) / (mini_step + 1)`;
    on the k-th mini-step (mini_step == k - 1) it moves the mean into
    `.grad`, for the clip and AdamW to apply, and starts a new mean.

    Two step counts follow from optax, and the train step keeps both: the
    schedule inside AdamW, and AdamW's bias correction, count real updates
    (MultiSteps steps its inner optimizer only on the k-th mini-step), while
    the step's logged `learning_rate` is `schedule(state.step)`, which
    counts mini-steps (vcvits_tpu/train/step.py). With k = 2 and a schedule
    halving each update, the updates are 0, -lr0, 0, -lr0/2, ... A quirk of
    the JAX package, mirrored here."""

    def __init__(self, params: Iterable[nn.Parameter], k: int):
        if k < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {k}")
        self.params: List[nn.Parameter] = list(params)
        self.k = k
        self.mean: List[torch.Tensor] = ([torch.zeros_like(p, dtype=torch.float32)
                                          for p in self.params] if k > 1 else [])

    @torch.no_grad()
    def fold(self, mini_step: int) -> bool:
        """Fold this mini-batch's gradients in; True on the k-th mini-step,
        with the mean in every `.grad`."""
        if self.k == 1:
            return True
        last = mini_step == self.k - 1
        for p, m in zip(self.params, self.mean):
            g = torch.zeros_like(m) if p.grad is None else p.grad.float()
            m.add_((g - m) / (mini_step + 1))
            if last:
                p.grad = m.to(p.dtype, copy=True)
                m.zero_()
        return last

    def state_dict(self, names: Mapping[int, str]) -> Dict[str, torch.Tensor]:
        """The running mean by parameter name (`names`: id(param) -> name)."""
        return {names[id(p)]: m for p, m in zip(self.params, self.mean)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, torch.Tensor], names: Mapping[int, str]) -> None:
        """Copy a saved mean in; a parameter the state lacks starts at 0."""
        for p, m in zip(self.params, self.mean):
            saved = state.get(names[id(p)])
            if saved is None:
                m.zero_()
            else:
                m.copy_(saved.to(m.device, m.dtype))


def _fill_missing_grads(params: Iterable[nn.Parameter]) -> None:
    """A zero gradient where none arrived, so AdamW still applies its weight
    decay, as optax does to every leaf."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def accumulate_and_step(opt: torch.optim.Optimizer, acc: GradAccumulator, mini_step: int,
                        grad_clip: Optional[float]) -> bool:
    """One mini-step of `optax.MultiSteps(chain(clip?, adamw), k)`: this
    mini-batch's `.grad`s into the running mean; on the k-th mini-step the
    value clip (when `grad_clip` is set) and AdamW on the mean. True when
    the parameters were updated."""
    if not acc.fold(mini_step):
        return False
    _fill_missing_grads(acc.params)
    if grad_clip is not None:
        torch.nn.utils.clip_grad_value_(acc.params, grad_clip)
    opt.step()
    return True
