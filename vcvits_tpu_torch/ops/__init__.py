"""The port's hand-written CUDA kernels and their plain PyTorch versions.

* `mrf` (K1): a HiFi-GAN stage's MRF, csrc/mrf.cu.
* `flow_coupling` (K2): one residual-coupling reverse, csrc/flow_coupling.cu.
* `stft_mel` (K3): STFT magnitude + log-mel in one pass, csrc/stft_mel.cu.
* `fused_gate` (K5): the WaveNet gate, forward and backward, csrc/fused_gate.cu.
* `int8_conv` (Q1, Q2): the W8A8 int8 decoder conv and its rows' maxima,
  csrc/int8_conv.cu (no Pallas counterpart: JAX runs an XLA int8 conv).
* `monotonic_align` (M1): the TTS path's monotonic alignment search,
  csrc/monotonic_align.cu (no Pallas counterpart: JAX runs two lax.scans).
* `hubert_gemm` (G1): HuBERT's dense layers in fp32 as 3xTF32 on wgmma,
  csrc/hubert_gemm.cu (no Pallas counterpart: JAX runs flax Dense layers).

Each wrapper runs its plain version for a CPU tensor and its kernel for a
CUDA tensor; `_build.LAUNCHES` counts the kernel launches.
"""
