"""GAN losses: LS-GAN, feature matching and the masked Gaussian KL.

Counterpart of vcvits_tpu/train/losses.py; every sum is float32 whatever
the compute dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """2 x the sum over every sub-discriminator feature map of
    mean |real - generated|; no gradient through the real maps."""
    loss = torch.zeros((), dtype=torch.float32, device=fmap_g[0][0].device)
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real: Sequence[torch.Tensor], disc_gen: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LS-GAN D loss: sum of mean (1 - D(y))^2 + mean D(y_hat)^2, with the
    per-head terms."""
    loss = torch.zeros((), dtype=torch.float32, device=disc_real[0].device)
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1.0 - dr.float()) ** 2)
        g = torch.mean(dg.float() ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_gen: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LS-GAN G loss: sum of mean (1 - D(y_hat))^2, with the per-head terms."""
    loss = torch.zeros((), dtype=torch.float32, device=disc_gen[0].device)
    gen_losses = []
    for dg in disc_gen:
        term = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor, logs_p: torch.Tensor,
            z_mask: torch.Tensor) -> torch.Tensor:
    """Masked KL(q || prior) of the flowed posterior; [B, T, C] inputs,
    [B, T, 1] mask, normalised by the mask's sum."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
