"""vcvits_tpu_torch: the PyTorch/CUDA port of vcvits_tpu for an NVIDIA H100.

This slice runs 48 kHz any-to-any conversion end to end: `VoiceConverter`
(infer.py) drives `SynthesizerSVC.infer` (models/synthesizer.py). The flow
reverse and every decoder MRF stage run through hand-written CUDA kernels
(ops/, csrc/), built with nvcc on first use. Entry points run on the card
unless the caller passes device="cpu", which takes the plain PyTorch path.
The package imports no JAX and nothing of vcvits_tpu.
"""

__version__ = "0.1.0"

from vcvits_tpu_torch.config import Config, load_config  # noqa: E402

__all__ = ["Config", "SynthesizerSVC", "VoiceConverter", "load_config"]


def __getattr__(name: str):
    """`VoiceConverter` and `SynthesizerSVC` on first use: importing the
    package (as the data pipeline's worker processes do) loads no torch."""
    if name == "VoiceConverter":
        from vcvits_tpu_torch.infer import VoiceConverter
        return VoiceConverter
    if name == "SynthesizerSVC":
        from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC
        return SynthesizerSVC
    raise AttributeError(f"module 'vcvits_tpu_torch' has no attribute {name!r}")
