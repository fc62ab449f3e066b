"""Typed configuration system (the port's own copy of vcvits_tpu/config.py).

The same frozen dataclasses and the same JSON schema as the JAX package, so
`configs/48k_base.json` and `configs/base.json` load unchanged in both.
Unknown JSON keys are rejected loudly instead of silently absorbed. The
training-only fields keep the JAX package's comments; the port's inference
path reads `data` and `model` only.

The port also loads VITS's own configs as published (`configs/vctk_base.json`,
github.com/jaywalnut310/vits): `train.epochs`, and `data.sampling_rate`
(the target rate), `add_blank`, `text_cleaners` and `cleaned_text`, which
the TTS CLI reads; and it takes the keys that select VITS's training
architecture, `model.msd_scales` (0: the multi-period discriminator
alone), `model.variance_predictors` (false: no pitch and energy heads)
and `model.n_vocab`. These port-only fields are left out of `to_dict`
while they hold their defaults, so a vcvits config's dict is the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(value: Any) -> Any:
    """Recursively convert lists to tuples so configs hash."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


# marks a field the JAX package's config does not have
PORT_ONLY = {"port_only": True}


def _from_dict(cls, data: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**{k: _freeze(v) for k, v in data.items()})


@dataclass(frozen=True)
class TrainerConfig:
    """Mirrors the `trainer` JSON block (configs/48k_base.json:2-8)."""

    max_epochs: int = 20000
    limit_val_batches: int = 1
    accumulate_grad_batches: int = 1
    default_root_dir: str = "./logs"
    val_check_interval: int = 1000


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors the `train` JSON block (configs/48k_base.json:9-26)."""

    log_interval: int = 200
    eval_interval: int = 1000
    seed: int = 1234
    max_epochs: int = 20000
    learning_rate: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 16
    fp16_run: bool = True  # interpreted as "use bf16 compute" on TPU
    lr_decay: float = 0.999875
    segment_size: int = 16384
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0
    # TPU-specific additions (not present in reference):
    checkpoint_interval: int = 2000  # reference: ModelCheckpoint every_n_train_steps=2000 (train.py:88)
    # None = derive from the actual loader (len(dataset)//batch) at trainer
    # build, matching the reference's true per-epoch ExponentialLR
    # (vcvits.py:247-263); set explicitly to override.
    steps_per_epoch: Optional[int] = None
    grad_clip: Optional[float] = None  # reference measures but never clips (commons.py:145-160)
    # fused Pallas STFT+mel for the frozen target features in the train step
    # (SURVEY §2.6 N1); auto-falls back to the XLA path off-TPU.
    pallas_frontend: bool = True
    # True = reference-exact D-step semantics (vcvits.py:151-183): recompute
    # the generator forward with post-update G weights and fresh random
    # slices before the D update (the reference's exact semantics,
    # vcvits.py:151-183). A measured 5k-step A/B (reports/ab_dstep_r2.json,
    # tools/ab_dstep.py) shows this converges markedly better than reusing
    # the G step's y_hat (mel 17.7 vs 22.8 over steps 4100-5000, with a
    # healthier D loss) — so reference semantics are the default; set False
    # to save the extra generator forward per step.
    d_recompute_forward: bool = True
    # Compute the frozen HuBERT backbone's features ONCE per step and inject
    # them into both the G-step forward and the d_recompute_forward D-step
    # forward. Bit-exact: the subtree is optimizer-masked (train/state.py:60)
    # and dropout-free (models/hubert.py), so both forwards would see
    # identical features anyway — this saves XLA from having to CSE two
    # ~95M-param subgraphs across an optimizer update. Measured A/B in
    # tools/bench_train_opts.py. No effect on the preload path (features
    # already come from the dataset).
    share_frozen_hubert: bool = True
    # Rematerialization policy for the train step's generator /
    # discriminator forwards: "none" (XLA decides what to keep), "dots"
    # (save only MXU matmul/conv results, recompute elementwise in the
    # backward), "nothing" (recompute everything). Trades HBM for FLOPs —
    # measured per-batch-size in tools/bench_train_opts.py; see ROADMAP.
    remat_policy: str = "none"
    # im2col the discriminators' in_channels=1 first convs into dense
    # matmuls (exact — tests/test_discriminators.py:128). Default ON: the
    # only option in the r4 B=16 sweep that beat the baseline
    # (reports/train_opts_r4.json: 164.7 vs 168.2 ms/step, +2.1%).
    disc_im2col: bool = True
    # Phase-packed grouped convs in the MSD heads (ops/grouped_conv.py):
    # pack P output positions x out/groups channels onto the MXU lane axis.
    # Exact (tests/test_grouped_conv.py) but measured SLOWER end-to-end at
    # B=16 (182.8 vs 168.2 ms/step, reports/train_opts_r4.json) — XLA's
    # native grouped-conv lowering on this chip beats the extra
    # reshape/transpose traffic the packing needs. Kept off; available for
    # future chips where tiny-group convs lower worse.
    disc_grouped_pack: bool = False
    # Time-fold (space-to-batch) the MSD grouped convs: split time into
    # overlapping chunks folded into batch so the TPU emitters' batch-in-
    # lanes layout fills all 128 lanes (ops/grouped_conv.py:
    # time_batch_conv1d). Exact (plain autodiff through the native conv).
    # Default ON: full-step A/B wins at every batch — 104.6 vs 121.0
    # ms/step at B=8 (+15.7%), 151.3 vs 164.8 at B=16 (+8.9%), 246.9 vs
    # 252.3 at B=32 (+2.2%) — reports/train_opts_r5.json.
    disc_time_fold: bool = True
    # Device-resident dataset cache (data/device_cache.py): upload the
    # corpus to HBM once and assemble batches with a jitted gather, so the
    # per-step host->device traffic is an index vector instead of audio.
    # "auto": on when the padded corpus fits device_cache_max_bytes and no
    # per-epoch augmentation needs fresh host data; "on"/"off" force it.
    device_data_cache: str = "auto"
    device_cache_max_bytes: int = 512 * 1024 * 1024
    # VITS's name for max_epochs (its train_ms.py loops `epochs` times)
    epochs: Optional[int] = field(default=None, metadata=PORT_ONLY)


@dataclass(frozen=True)
class DataConfig:
    """Mirrors the `data` JSON block (configs/48k_base.json:27-44)."""

    training_files: str = "filelists/train.txt"
    validation_files: str = "filelists/valid.txt"
    source_sampling_rate: int = 16000
    target_sampling_rate: int = 48000
    filter_length: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    n_speakers: int = 512
    hubert_ckpt: str = "checkpoints/hubert_base"
    hubert_channels: int = 768
    hubert_downsample: int = 320
    num_pitch: int = 512
    max_wav_value: float = 32768.0
    # TPU-specific: static-shape bucketing for XLA (reference pads dynamically,
    # collate.py:133-191; XLA needs a fixed set of shapes).
    max_source_seconds: float = 10.0
    length_buckets: Tuple[float, ...] = (2.0, 4.0, 6.0, 8.0, 10.0)
    cache_dir: str = "cache"
    # VITS's data keys: its one sampling rate is the target rate (from_dict
    # copies it there); blank ids between symbols, the text cleaners, and
    # whether the filelist's text is cleaned already (the TTS CLI's
    # defaults)
    sampling_rate: Optional[int] = field(default=None, metadata=PORT_ONLY)
    add_blank: bool = field(default=False, metadata=PORT_ONLY)
    text_cleaners: Optional[Tuple[str, ...]] = field(default=None, metadata=PORT_ONLY)
    cleaned_text: bool = field(default=False, metadata=PORT_ONLY)

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    """Mirrors the `model` JSON block (configs/48k_base.json:45-68)."""

    hubert_ckpt: str = "checkpoints/hubert_base"
    num_pitch: int = 512
    inter_channels: int = 128
    hidden_channels: int = 128
    hubert_channels: int = 768
    filter_channels: int = 768
    n_heads: int = 4
    n_layers: int = 3
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 4, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    n_layers_q: int = 3
    use_spectral_norm: bool = False
    gin_channels: int = 256
    multi_period_discriminator_periods: Tuple[int, ...] = (
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37,
    )
    # Dilation-phase-split folded decoder (models/hifigan.py phase_split):
    # exact — same params, same outputs — with ~2-3x fewer MACs on the
    # dilated MRF taps. Default set by measurement (tools/bench_decoder.py
    # --phase-split A/B); not a JSON key in the reference.
    dec_phase_split: bool = False
    # Dynamic W8A8 int8 decoder convs (models/hifigan.py quant_int8):
    # inference-only, same checkpoint (weights quantize at call time).
    # Not a JSON key in the reference; default OFF — enable per run with
    # --int8-decoder on the infer/serve CLIs.
    dec_quant_int8: bool = False
    # The training architecture: the multi-scale discriminator's heads
    # beside the multi-period one (0 leaves it out, as VITS has it), the
    # TTS model's pitch and energy predictors and their losses (VITS has
    # none), and the text encoder's vocabulary (None: the port's symbol
    # set).
    msd_scales: int = field(default=5, metadata=PORT_ONLY)
    variance_predictors: bool = field(default=True, metadata=PORT_ONLY)
    n_vocab: Optional[int] = field(default=None, metadata=PORT_ONLY)


@dataclass(frozen=True)
class Config:
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "Config":
        # the reference duplicates these in the data and model blocks; if the
        # model block overrides one, keep the data block in lockstep so the
        # host pipeline quantizes into the range the embeddings expect.
        data = {k: dict(v) for k, v in data.items()}
        model_blk = data.get("model", {})
        data_blk = data.setdefault("data", {})
        for dup in ("num_pitch", "hubert_channels"):
            if dup in model_blk and dup not in data_blk:
                data_blk[dup] = model_blk[dup]
        sr = data_blk.get("sampling_rate")
        if sr is not None:
            if data_blk.setdefault("target_sampling_rate", sr) != sr:
                raise ValueError(f"data.sampling_rate ({sr}) != data.target_sampling_rate "
                                 f"({data_blk['target_sampling_rate']})")
        cfg = Config(
            trainer=_from_dict(TrainerConfig, data.get("trainer", {})),
            train=_from_dict(TrainConfig, data.get("train", {})),
            data=_from_dict(DataConfig, data_blk),
            model=_from_dict(ModelConfig, model_blk),
        )
        if cfg.data.num_pitch != cfg.model.num_pitch:
            raise ValueError(
                f"data.num_pitch ({cfg.data.num_pitch}) != model.num_pitch "
                f"({cfg.model.num_pitch}); the pitch quantizer and embedding "
                "table must agree"
            )
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        """Every field, but a port-only one at its default."""
        out = dataclasses.asdict(self)
        for blk in dataclasses.fields(self):
            value = getattr(self, blk.name)
            for f in dataclasses.fields(value):
                if f.metadata.get("port_only") and getattr(value, f.name) == f.default:
                    del out[blk.name][f.name]
        return out


def load_config(path: str) -> Config:
    """Load a JSON config file (same schema as the reference configs/)."""
    with open(path, "r") as f:
        return Config.from_dict(json.load(f))
