"""Multi-period + multi-scale GAN discriminators, PyTorch.

Counterpart of vcvits_tpu/models/discriminators.py: `DiscriminatorP`
(period p: time folded to [B, T/p, p, 1], (5,1)/(3,1) weight-normed 2-D
convs, NHWC as in JAX), `DiscriminatorS` (grouped 1-D convs, kernels
15/41/5), `MultiPeriodDiscriminator` (one scale head + one period head per
period: 13 heads for the 48 kHz config) and `MultiScaleDiscriminator` (5
scale heads on an AvgPool1d(4, 2, pad 2) cascade). Each head runs the real
and generated waveforms as one batch (JAX's batch_pair), which is exact.

The JAX package's im2col_first, grouped_pack and time_fold flags are exact
TPU rewrites of these convs: the port accepts them and computes the plain
convs. `PitchDiscriminator` (the MSD pattern over F0 contours) is ported
and, as in JAX, not in the train step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.models.layers import LRELU_SLOPE, Conv1d, Conv2dNorm, leaky_relu

FeatureMaps = List[torch.Tensor]
Outputs = Tuple[List[torch.Tensor], List[torch.Tensor], List[FeatureMaps], List[FeatureMaps]]

# (features, kernel, stride, groups, padding) of DiscriminatorS's conv stack
_SCALE_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
                (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))


class DiscriminatorP(nn.Module):
    """Period-p head on [B, T, 1]; returns (logits [B, -1], feature maps)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False, dtype=torch.float32):
        super().__init__()
        self.period = period
        kp = (kernel_size - 1) // 2
        wn, sn = not use_spectral_norm, use_spectral_norm
        cin = 1
        for i, ch in enumerate((32, 128, 512, 1024)):
            self.add_module(f"conv_{i}", Conv2dNorm(
                cin, ch, (kernel_size, 1), (stride, 1), ((kp, kp), (0, 0)), weight_norm=wn,
                spectral_norm=sn, dtype=dtype))
            cin = ch
        self.conv_4 = Conv2dNorm(1024, 1024, (kernel_size, 1), (1, 1), ((kp, kp), (0, 0)),
                                 weight_norm=wn, spectral_norm=sn, dtype=dtype)
        self.conv_post = Conv2dNorm(1024, 1, (3, 1), (1, 1), ((1, 1), (0, 0)), weight_norm=wn,
                                    spectral_norm=sn, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, FeatureMaps]:
        b, t, c = x.shape
        p = self.period
        if t % p != 0:
            n_pad = p - t % p
            x = F.pad(x.transpose(1, 2), (0, n_pad), mode="reflect").transpose(1, 2)
            t += n_pad
        x = x.reshape(b, t // p, p, c)
        fmap: FeatureMaps = []
        for i in range(5):
            x = leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale head on [B, T, 1]; returns (logits [B, -1], feature maps)."""

    def __init__(self, use_spectral_norm: bool = False, im2col_first: bool = False,
                 grouped_pack: bool = False, time_fold: bool = False, dtype=torch.float32):
        super().__init__()
        wn, sn = not use_spectral_norm, use_spectral_norm
        cin = 1
        for i, (f, k, s, g, p) in enumerate(_SCALE_SPECS):
            self.add_module(f"conv_{i}", Conv1d(cin, f, k, stride=s, groups=g, padding=(p, p),
                                                weight_norm=wn, spectral_norm=sn, dtype=dtype))
            cin = f
        self.conv_post = Conv1d(cin, 1, 3, padding=(1, 1), weight_norm=wn, spectral_norm=sn,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, FeatureMaps]:
        fmap: FeatureMaps = []
        for i in range(len(_SCALE_SPECS)):
            x = leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def avg_pool_4_2(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(kernel=4, stride=2, padding=2, count_include_pad=True)
    on [B, T, C]."""
    return F.avg_pool1d(x.transpose(1, 2), 4, 2, padding=2,
                        count_include_pad=True).transpose(1, 2)


def _paired(head: nn.Module, x: torch.Tensor, b: int):
    """One pass of the head over [real; generated], split back."""
    logits, fmap = head(x)
    return logits[:b], logits[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]


def _collect(results) -> Outputs:
    lr, lg, fr, fg = zip(*results)
    return list(lr), list(lg), list(fr), list(fg)


class MultiPeriodDiscriminator(nn.Module):
    """One DiscriminatorS (`disc_s`) + one DiscriminatorP per period
    (`disc_p{p}`). forward(y, y_hat) -> (logits_r, logits_g, fmaps_r, fmaps_g)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37),
                 use_spectral_norm: bool = False, batch_pair: bool = True,
                 im2col_first: bool = False, grouped_pack: bool = False,
                 time_fold: bool = False, dtype=torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        self.disc_s = DiscriminatorS(use_spectral_norm, im2col_first, grouped_pack, time_fold,
                                     dtype=dtype)
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(p, use_spectral_norm=use_spectral_norm,
                                                         dtype=dtype))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
        x = torch.cat([y, y_hat.to(y.dtype)], dim=0)
        heads = [self.disc_s] + [getattr(self, f"disc_p{p}") for p in self.periods]
        return _collect(_paired(head, x, y.shape[0]) for head in heads)


class MultiScaleDiscriminator(nn.Module):
    """`n_scales` DiscriminatorS heads (`disc_{i}`), head i on the input
    average-pooled i times. Spectral norm, when asked for, applies to the
    first head only."""

    def __init__(self, n_scales: int = 5, use_spectral_norm: bool = False,
                 batch_pair: bool = True, im2col_first: bool = False,
                 grouped_pack: bool = False, time_fold: bool = False, dtype=torch.float32):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"disc_{i}", DiscriminatorS(
                use_spectral_norm and i == 0, im2col_first, grouped_pack, time_fold,
                dtype=dtype))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
        x = torch.cat([y, y_hat.to(y.dtype)], dim=0)
        results = []
        for i in range(self.n_scales):
            if i != 0:
                x = avg_pool_4_2(x)
            results.append(_paired(getattr(self, f"disc_{i}"), x, y.shape[0]))
        return _collect(results)


# (features, kernel, stride, groups, padding) of PitchDiscriminator's heads
_PITCH_SPECS = ((16, 15, 1, 1, 7), (64, 15, 2, 4, 7), (128, 15, 2, 16, 7), (128, 5, 1, 1, 2))


class PitchDiscriminator(nn.Module):
    """Multi-scale discriminator over F0 contours, the counterpart of
    vcvits_tpu/models/discriminators.py:PitchDiscriminator: `n_scales`
    weight-normed heads of narrow grouped convs (`disc_{i}_conv_{j}`, then
    `disc_{i}_post`), head i on the [real; generated] batch average-pooled
    i times. Inputs [B, T_frames, 1] (normalised F0). Not wired into the
    train step's losses, as in JAX. forward(y, y_hat) -> (logits_r,
    logits_g, fmaps_r, fmaps_g)."""

    def __init__(self, n_scales: int = 3, dtype=torch.float32):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            cin = 1
            for j, (f, k, s, g, p) in enumerate(_PITCH_SPECS):
                self.add_module(f"disc_{i}_conv_{j}", Conv1d(
                    cin, f, k, stride=s, groups=g, padding=(p, p), weight_norm=True, dtype=dtype))
                cin = f
            self.add_module(f"disc_{i}_post", Conv1d(cin, 1, 3, padding=(1, 1), weight_norm=True,
                                                     dtype=dtype))

    def _head(self, i: int, x: torch.Tensor) -> Tuple[torch.Tensor, FeatureMaps]:
        fmap: FeatureMaps = []
        for j in range(len(_PITCH_SPECS)):
            x = leaky_relu(getattr(self, f"disc_{i}_conv_{j}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = getattr(self, f"disc_{i}_post")(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor) -> Outputs:
        x = torch.cat([y, y_hat.to(y.dtype)], dim=0)
        results = []
        for i in range(self.n_scales):
            if i != 0:
                x = avg_pool_4_2(x)
            results.append(_paired(lambda h, i=i: self._head(i, h), x, y.shape[0]))
        return _collect(results)


class Discriminators(nn.Module):
    """The train step's discriminators, `mpd` and `msd` (the JAX package's
    d_params tree {"mpd": ..., "msd": ...}); `msd` is None where the
    configuration has no multi-scale heads (`model.msd_scales` 0, VITS's
    set: the multi-period discriminator alone)."""

    def __init__(self, mpd: MultiPeriodDiscriminator, msd: Optional[MultiScaleDiscriminator]):
        super().__init__()
        self.mpd = mpd
        self.msd = msd

    @classmethod
    def from_config(cls, cfg: Config, dtype=torch.float32) -> "Discriminators":
        t = cfg.train
        flags = dict(im2col_first=t.disc_im2col, grouped_pack=t.disc_grouped_pack,
                     time_fold=t.disc_time_fold, dtype=dtype)
        n = cfg.model.msd_scales
        return cls(MultiPeriodDiscriminator(cfg.model.multi_period_discriminator_periods,
                                            **flags),
                   MultiScaleDiscriminator(n, **flags) if n > 0 else None)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor
                ) -> Tuple[Outputs, Optional[Outputs]]:
        """(the MPD's outputs, the MSD's or None)."""
        return self.mpd(y, y_hat), None if self.msd is None else self.msd(y, y_hat)
