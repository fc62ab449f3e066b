"""Analytic operation counts of the conversion generator's inference.

Counted as `torch.utils.flop_counter.FlopCounterMode` counts them: two
operations per multiply-add of every matrix product and convolution
(transposed convolutions over their input positions), and nothing for
elementwise work. `infer_flops` is what one request needs alone, at its
own alignment-unit padded length, so a batch's padding rows and padded
samples are not counted as useful work.
"""

from __future__ import annotations

from benchmark.reference.vc import (
    FLOW_K, FLOW_LAYERS, HUBERT_PAD, LENGTH_SCALE, N_FLOWS, Hubert)


def hubert_flops(hub: Hubert, n_in: int) -> tuple:
    """(flops, frames) of HuBERT on n_in samples (already padded by 40 a side)."""
    f, t, cin = 0, n_in, 1
    for dim, k, s in hub.conv_layers:
        t = (t - k) // s + 1
        f += 2 * t * dim * cin * k
        cin = dim
    h = hub.hidden
    f += 2 * t * cin * h                                             # post_extract_proj
    f += 2 * (t + 1) * h * (h // hub.pos_groups) * hub.pos_k       # positional conv
    per_layer = 2 * t * h * h * 4 + 2 * 2 * t * t * h + 2 * 2 * t * h * hub.ffn
    return f + hub.layers * per_layer, t


def content_flops(model: dict, hub: Hubert, n_wav: int) -> tuple:
    """(flops, frames) of the content encoder on a padded 16 kHz source."""
    f, t = hubert_flops(hub, n_wav + 2 * HUBERT_PAD)
    h, fc, k = model["hidden_channels"], model["filter_channels"], model["kernel_size"]
    f += 2 * t * hub.hidden * h                                     # hubert_proj
    attn = 2 * t * h * h * 4 + 2 * 2 * t * t * h + 2 * 2 * t * (2 * t - 1) * h
    ffn = 2 * 2 * t * fc * h * k
    f += model["n_layers"] * (attn + ffn)
    f += 2 * t * 2 * model["inter_channels"] * h                    # proj
    return f, t


def flow_flops(model: dict, t: int) -> int:
    """The four couplings' reverse on t frames, with the speaker layer."""
    h, half, gin = model["hidden_channels"], model["inter_channels"] // 2, model["gin_channels"]
    per = 2 * t * half * h * 2                                      # pre and post
    per += FLOW_LAYERS * 2 * t * 2 * h * h * FLOW_K                 # dilated convs
    per += (FLOW_LAYERS - 1) * 2 * t * 2 * h * h + 2 * t * h * h    # res_skip
    if gin > 0:
        per += 2 * gin * FLOW_LAYERS * 2 * h                        # speaker layer
    return N_FLOWS * per


def decoder_flops(model: dict, t: int) -> int:
    """The HiFi-GAN decoder on t latent frames."""
    c0, inter, gin = model["upsample_initial_channel"], model["inter_channels"], \
        model["gin_channels"]
    f = 2 * t * c0 * inter * 7 + (2 * gin * c0 if gin > 0 else 0)
    n_w = 2 * sum(k * len(d) for k, d in zip(model["resblock_kernel_sizes"],
                                             model["resblock_dilation_sizes"]))
    ch, rows = c0, t
    for i, (u, k) in enumerate(zip(model["upsample_rates"], model["upsample_kernel_sizes"])):
        co = c0 // 2 ** (i + 1)
        f += 2 * rows * ch * co * k                                 # transposed conv
        rows *= u
        f += 2 * rows * co * co * n_w                               # MRF
        ch = co
    return f + 2 * rows * ch * 7                                    # conv_post


def infer_flops(model: dict, hub: Hubert, n_wav: int) -> int:
    """One request of n_wav (alignment-unit padded) 16 kHz samples."""
    f, _ = content_flops(model, hub, n_wav)
    t_out = int(round(n_wav * LENGTH_SCALE))
    return f + flow_flops(model, t_out) + decoder_flops(model, t_out)


def train_step_flops(cfg: dict, hub: Hubert, x_shape: tuple, y_shape: tuple) -> int:
    """The operations one train step's algorithm needs at these batch shapes
    (x_wav [B, Tx], y_wav [B, Ty]): HuBERT's forward, the generator's
    forward and backward, MPD + MSD on real and generated segments in both
    updates, the D update's generator forward; no recompute. Counted by
    `FlopCounterMode` over benchmark/reference/train.py's step on the meta
    device, where nothing runs: only shapes flow."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import train as ref_train
    from benchmark.reference.vc import param_specs

    model, data = cfg["model"], cfg["data"]
    meta = torch.device("meta")

    def weights(specs):
        return {n: torch.empty(s, device=meta) for n, s, _ in specs}

    b = x_shape[0]
    hop = data["hop_length"]
    batch = {"x_wav": torch.empty(x_shape, device=meta),
             "x_wav_lengths": torch.full((b,), x_shape[1], dtype=torch.int32, device=meta),
             "x_pitch": torch.ones((b, x_shape[1] // 320), dtype=torch.int64, device=meta),
             "y_wav": torch.empty(y_shape, device=meta),
             "y_wav_lengths": torch.full((b,), y_shape[1], dtype=torch.int32, device=meta),
             "sid": torch.zeros((b,), dtype=torch.int64, device=meta)}
    t_spec = y_shape[1] // hop
    draw = {}
    for sfx in ("", "2"):
        draw["eps" + sfx] = torch.empty((b, t_spec, model["inter_channels"]), device=meta)
        draw["ids_str" + sfx] = torch.zeros((b,), dtype=torch.int32, device=meta)
    with FlopCounterMode(display=False) as counter:
        ref_train.train_steps(weights(param_specs(model, data, hub)),
                              weights(ref_train.disc_specs(model)), cfg, hub, [batch], [draw], 0)
    return int(counter.get_total_flops())
