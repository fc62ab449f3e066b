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
from vcvits_tpu_torch.infer import VoiceConverter  # noqa: E402
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC  # noqa: E402

__all__ = ["Config", "SynthesizerSVC", "VoiceConverter", "load_config"]
