"""WAV file I/O (RIFF PCM 16/24/32-bit and float32), no external deps.

The port's copy of vcvits_tpu/utils/audio_io.py: torchaudio.load's
normalized float32 with channel-mean downmix, and soundfile.write's PCM_24.
Pure NumPy RIFF parsing; host-side only.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str, downmix: bool = True) -> Tuple[np.ndarray, int]:
    """Returns (float32 waveform in [-1, 1], sample_rate).

    [T] if downmix else [C, T]. Supports PCM 16/24/32-bit int and
    32/64-bit float WAVs (including WAVE_FORMAT_EXTENSIBLE).
    """
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

        audio_format, channels, sr, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and len(fmt) >= 40:  # extensible: subformat GUID
            audio_format = struct.unpack("<H", fmt[24:26])[0]

        if audio_format == 1:  # PCM int
            if bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8)
                raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
                x = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                x = (x ^ 0x800000) - 0x800000  # sign-extend
                x = x.astype(np.float32) / 8388608.0
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
            elif bits == 8:
                x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
        elif audio_format == 3:  # IEEE float
            if bits == 32:
                x = np.frombuffer(data, dtype="<f4").astype(np.float32)
            elif bits == 64:
                x = np.frombuffer(data, dtype="<f8").astype(np.float32)
            else:
                raise ValueError(f"{path}: unsupported float bit depth {bits}")
        else:
            raise ValueError(f"{path}: unsupported WAV format {audio_format}")

    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels).T
        if downmix:
            x = x.mean(axis=0)
    return np.ascontiguousarray(x), sr


def write_wav(path: str, data: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write mono/multichannel float data. subtype: PCM_16 | PCM_24 | FLOAT."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:  # [C, T] -> interleaved
        channels = data.shape[0]
        data = data.T.reshape(-1)
    else:
        channels = 1
        data = data.reshape(-1)

    if subtype == "PCM_16":
        fmt_code, bits = 1, 16
        clipped = np.clip(data, -1.0, 1.0)
        payload = (clipped * 32767.0).round().astype("<i2").tobytes()
    elif subtype == "PCM_24":
        fmt_code, bits = 1, 24
        clipped = np.clip(data, -1.0, 1.0)
        ints = (clipped * 8388607.0).round().astype(np.int32)
        b = np.zeros((len(ints), 3), dtype=np.uint8)
        b[:, 0] = ints & 0xFF
        b[:, 1] = (ints >> 8) & 0xFF
        b[:, 2] = (ints >> 16) & 0xFF
        payload = b.tobytes()
    elif subtype == "FLOAT":
        fmt_code, bits = 3, 32
        payload = data.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = channels * bits // 8
    byte_rate = sr * block_align
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", fmt_code, channels, sr, byte_rate, block_align, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
