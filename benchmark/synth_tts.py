"""Seeded TTS training batches: speech-like waves with symbol ids.

A row is a wave of a length drawn in whole spectrogram frames, synthesized
at the configuration's rate by benchmark/synth.py's formant source, and a
text of a drawn number of symbol ids from [1, n_vocab) with the blank id
0 between them and at both ends (VITS's add_blank), so a text of n ids is
2n + 1 long. Rows are zero-padded to the bucket's frames and to the
batch's longest text, as VITS's collate pads them; everything is made on
the device from a `torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import synth


def make_tts_batch(n_rows: int, frames_lo: int, frames_hi: int, pad_frames: int,
                   ids_lo: int, ids_hi: int, n_vocab: int, n_speakers: int, hop: int, sr: int,
                   gen: torch.Generator, device, blank: bool = True) -> dict:
    """A batch of n_rows: spectrogram lengths uniform in (frames_lo,
    frames_hi], waves padded to pad_frames * hop samples; texts of ids_lo
    to ids_hi symbol ids (blanks interleaved where `blank`); speakers
    uniform in [0, n_speakers). Tensors on `device`: text [B, T_x] int64,
    text_lengths [B], y_wav [B, pad_frames * hop], y_wav_lengths [B] (whole
    frames), sid [B]."""
    frames = torch.randint(frames_lo + 1, frames_hi + 1, (n_rows,), generator=gen,
                           device=device).tolist()
    n_ids = torch.randint(ids_lo, ids_hi + 1, (n_rows,), generator=gen, device=device).tolist()
    y = torch.zeros((n_rows, pad_frames * hop), device=device)
    for i, f in enumerate(frames):
        wav, _ = synth.synth(f * hop, gen, device, synth._vowels(gen, device), sr=sr)
        y[i, :f * hop] = wav
    t_x = max(2 * n + 1 if blank else n for n in n_ids)
    text = torch.zeros((n_rows, t_x), dtype=torch.int64, device=device)
    lengths = []
    for i, n in enumerate(n_ids):
        ids = torch.randint(1, n_vocab, (n,), generator=gen, device=device)
        if blank:
            text[i, 1:2 * n + 1:2] = ids
            lengths.append(2 * n + 1)
        else:
            text[i, :n] = ids
            lengths.append(n)
    sid = torch.randint(0, n_speakers, (n_rows,), generator=gen, device=device)
    return {"text": text, "text_lengths": torch.tensor(lengths, dtype=torch.int32, device=device),
            "y_wav": y,
            "y_wav_lengths": torch.tensor(np.array(frames) * hop, dtype=torch.int32,
                                          device=device),
            "sid": sid}
