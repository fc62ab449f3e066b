"""The JAX package's int8 decoder on chip_smoke.py's path A weights, beside
the port's, on the CPU: where the JAX gates of tests/test_int8_decoder.py
(W8A8 >= 24 dB and w8 >= 32 dB from the fp32 float decode, mel-L1 <= 0.05
from the bf16 one) stand for those weights in the reference itself.

    JAX_PLATFORMS=cpu python -m tests.int8_path_a_reference [frames]

Both decoders take the weights of `chip_smoke.perturbed_state` (seeded, the
decoder's weight-norm gains x 3) through the reference checkpoint layout
(the port's export, JAX's import) and the same x [1, frames, 128] and g
from a seed; prints each one's SNRs, mel-L1 and their distance. Not a
test: it compiles the full-width decoder five times in JAX (about a minute).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from vcvits_tpu.config import load_config as jax_load_config
from vcvits_tpu.convert.vcvits_torch import convert_hifigan_generator
from vcvits_tpu.dsp.spectrogram import mel_spectrogram
from vcvits_tpu.models.hifigan import HiFiGANGenerator as JaxGenerator
from vcvits_tpu_torch.config import load_config
from vcvits_tpu_torch.convert.export_torch import export_generator
from vcvits_tpu_torch.models.hifigan import HiFiGANGenerator

RUNS = (("float fp32", False, "float32"), ("float bf16", False, "bfloat16"),
        ("w8a8 fp32", True, "float32"), ("w8a8 bf16", True, "bfloat16"),
        ("w8 fp32", "w8", "float32"))


def _snr(ref, test):
    return 10 * np.log10(np.mean(ref.astype(np.float64) ** 2) / np.mean((ref - test) ** 2))


def _report(name, ys):
    def mel(y):
        return np.asarray(mel_spectrogram(jnp.asarray(y[None]), 2048, 128, 48000, 512, 2048))

    ref = ys["float fp32"]
    print(f"{name}: SNR vs float fp32: " + ", ".join(
        f"{k} {_snr(ref, ys[k]):.2f} dB" for k, _, _ in RUNS[1:]) + "; mel-L1 w8a8 bf16 vs float "
        f"bf16 {np.abs(mel(ys['w8a8 bf16']) - mel(ys['float bf16'])).mean():.4f}")


def main(frames: int = 20) -> None:
    cfg = load_config(chip_smoke.CONFIG)
    m = cfg.model
    sd = chip_smoke.perturbed_state(cfg)
    jparams = convert_hifigan_generator(export_generator(sd, cfg),
                                        jax_load_config(chip_smoke.CONFIG), prefix="dec.")
    kw = dict(initial_channel=m.inter_channels, resblock=m.resblock,
              resblock_kernel_sizes=m.resblock_kernel_sizes,
              resblock_dilation_sizes=m.resblock_dilation_sizes, upsample_rates=m.upsample_rates,
              upsample_initial_channel=m.upsample_initial_channel,
              upsample_kernel_sizes=m.upsample_kernel_sizes, gin_channels=m.gin_channels)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, frames, m.inter_channels)).astype(np.float32)
    g = rng.standard_normal((1, m.gin_channels)).astype(np.float32)
    jax_ys, port_ys = {}, {}
    for name, quant, dtype in RUNS:
        jm = JaxGenerator(dtype=getattr(jnp, dtype), quant_int8=quant, **kw)
        jax_ys[name] = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x, g))(jparams),
                                  np.float32)[0, :, 0]
        tm = HiFiGANGenerator(quant_int8=quant, dtype=getattr(torch, dtype), **kw)
        tm.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("dec.")})
        with torch.no_grad():
            port_ys[name] = tm(torch.from_numpy(x), torch.from_numpy(g)).float().numpy()[0, :, 0]
    _report(f"JAX, path A weights, decoder alone, {frames} frames", jax_ys)
    _report(f"port, the same", port_ys)
    print("port vs JAX SNR: " + ", ".join(f"{k} {_snr(jax_ys[k], port_ys[k]):.2f} dB"
                                          for k, _, _ in RUNS))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
