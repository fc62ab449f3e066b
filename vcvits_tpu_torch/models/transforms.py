"""Piecewise rational-quadratic spline transforms (neural spline flows).

Counterpart of vcvits_tpu/models/transforms.py: the spline on
[left, right] -> [bottom, top] with K bins (softmax widths and heights
above a minimum, softplus derivatives), its analytic inverse and
log|det|, and the 'linear' tails outside [-tail_bound, tail_bound] (the
spline evaluated on clamped inputs everywhere, then selected by region, as
JAX does). The bin search keeps JAX's eps on the last edge. It is the
coupling function of `ConvFlow`, inside the stochastic duration predictor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Index of the bin holding each input; bin_locations [..., K+1]."""
    bl = bin_locations.clone()
    bl[..., -1] += eps
    return torch.sum(inputs[..., None] >= bl, dim=-1) - 1


def _edges(unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float):
    """(bin sizes, cumulative edges [..., K+1]) from unnormalized sizes."""
    k = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1.0 - min_bin * k) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum[..., 1:] - cum[..., :-1], cum


def rational_quadratic_spline(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor, unnormalized_derivatives: torch.Tensor,
        inverse: bool = False, left: float = 0.0, right: float = 1.0, bottom: float = 0.0,
        top: float = 1.0, min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline on [left, right] -> [bottom, top]. inputs [...]; widths
    and heights [..., K], derivatives [..., K+1]. Returns (outputs,
    log|det|) of the forward, or of the inverse with `inverse`."""
    num_bins = unnormalized_widths.shape[-1]
    widths, cumwidths = _edges(unnormalized_widths, left, right, min_bin_width)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)
    heights, cumheights = _edges(unnormalized_heights, bottom, top, min_bin_height)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)[..., None]
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)

    def take(arr):
        return torch.gather(arr, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_heights = take(heights)
    delta = heights / widths
    input_delta = take(delta)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_p1 = take(derivatives[..., 1:])
    slope_sum = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        a = (inputs - input_cumheights) * slope_sum \
            + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope_sum
        c = -input_delta * (inputs - input_cumheights)
        discriminant = torch.clamp_min(b ** 2 - 4 * a * c, 0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + slope_sum * theta_one_minus_theta
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_p1 * root ** 2 + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2)
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet

    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta ** 2
                                 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + slope_sum * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_p1 * theta ** 2 + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor, unnormalized_derivatives: torch.Tensor,
        inverse: bool = False, tail_bound: float = 5.0,
        min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear tails outside [-tail_bound, tail_bound]: the identity there,
    with log|det| 0; the boundary derivatives padded to 1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    one = torch.tensor(1.0 - min_derivative, dtype=torch.float32)
    constant = float(torch.log(torch.expm1(one)))
    ud = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    spl_out, spl_lad = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, ud, inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    outputs = torch.where(inside, spl_out, inputs)
    logabsdet = torch.where(inside, spl_lad, torch.zeros_like(spl_lad))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor, unnormalized_derivatives: torch.Tensor,
        inverse: bool = False, tails: Optional[str] = None, tail_bound: float = 5.0
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entry point: the bare spline on [0, 1] (tails None) or with
    linear tails."""
    if tails is None:
        return rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                                         unnormalized_derivatives, inverse=inverse)
    if tails != "linear":
        raise ValueError(f"tails must be None or 'linear', got {tails!r}")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, tail_bound=tail_bound)
