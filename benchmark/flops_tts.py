"""Analytic operation count of VITS's train step (the TTS model's GAN
step), counted as benchmark/flops.py counts the conversion model's: two
operations per multiply-add of every matrix product and convolution, by
`torch.utils.flop_counter.FlopCounterMode` over
benchmark/reference/tts.py's step on the meta device, where only shapes
flow: the text encoder, posterior, flow, neg_cent, the expanded prior, the
duration predictor, the decoder on the segment, the multi-period
discriminator on [target; generated] in the G and the D update, and both
backwards. MAS and the spline's elementwise work count nothing."""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=32)
def _count(cfg_key: str, text_shape: tuple, y_shape: tuple) -> int:
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import tts as ref_tts

    cfg = json.loads(cfg_key)
    model, data = cfg["model"], ref_tts.target_data(cfg["data"])
    meta = torch.device("meta")

    def weights(specs):
        return {n: torch.empty(s, device=meta) for n, s, _ in specs}

    b, t_x = text_shape
    t_y = y_shape[1] // data["hop_length"]
    batch = {"text": torch.zeros(text_shape, dtype=torch.int64, device=meta),
             "text_lengths": torch.full((b,), t_x, dtype=torch.int32, device=meta),
             "y_wav": torch.empty(y_shape, device=meta),
             "y_wav_lengths": torch.full((b,), y_shape[1], dtype=torch.int32, device=meta),
             "sid": torch.zeros((b,), dtype=torch.int64, device=meta)}
    draw = {"eps": torch.empty((b, t_y, model["inter_channels"]), device=meta),
            "e_q": torch.empty((b, t_x, 2), device=meta),
            "ids_str": torch.zeros((b,), dtype=torch.int32, device=meta)}
    with FlopCounterMode(display=False) as counter:
        ref_tts.train_steps(weights(ref_tts.param_specs(model, data)),
                            weights(ref_tts.disc_specs(model)), cfg, [batch], [draw], 0)
    return int(counter.get_total_flops())


# the text lengths the count is taken at; every other one is interpolated
BASE_T_X = 200


def train_step_flops(cfg: dict, text_shape: tuple, y_shape: tuple) -> int:
    """The operations one step needs at these batch shapes (text [B, T_x],
    y_wav [B, T]). Every product's operations are a polynomial of degree 2
    in T_x (the attention's T_x x T_x scores, the rest linear), so the
    count at T_x = BASE_T_X, + 1 and + 2 gives it exactly at any T_x, in
    integers: three counts per batch shape, whatever the texts."""
    import json

    key = json.dumps(cfg, sort_keys=True)
    b, t_x = text_shape
    f0, f1, f2 = (_count(key, (b, BASE_T_X + i), tuple(y_shape)) for i in range(3))
    n = t_x - BASE_T_X
    return f0 + n * (f1 - f0) + n * (n - 1) // 2 * (f2 - 2 * f1 + f0)
