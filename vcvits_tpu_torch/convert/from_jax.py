"""JAX parameter trees (as numpy arrays) -> the port's state dicts.

`params_from_jax(g_params, cfg)` takes the JAX package's generator
parameters with every leaf a numpy array (for example
`jax.tree.map(np.asarray, params)`) and returns a state dict for the port's
module of the same subtree: `SynthesizerSVC` or `SynthesizerTTS` for a
whole generator, or any submodule for a subtree (the TTS tree's names,
`enc_p.emb`, `duration_predictor.flow_i` / `post_flow_i` / `convs.sep_i`,
`pitch_predictor.layer_i.norm.scale`, ..., are the port's module names,
flax's nn.LayerNorm `scale` / `bias` included). `disc_params_from_jax(d_params)` does the same
for the discriminators' {"mpd": ..., "msd": ...} tree, for the port's
`Discriminators` (models/discriminators.py). `train_state_from_jax(state,
cfg)` turns a whole JAX `GANTrainState` (numpy leaves) into the port's
checkpoint content (`TrainStep.state_dict()`), Adam moments included, so a
run started in JAX resumes in the port (`tts_train_state_from_jax` does the
same for a TTS run's state); a state with gradient accumulation
(`optax.MultiSteps`) carries its accumulator over as well. It imports no JAX and no optax.
The rules, by leaf name:

* flax `Dense.kernel` [in, out]       -> `weight` [out, in]   (kernel.T)
* conv `kernel` / `v` [k, in, out]    -> `weight` / `v` [out, in, k]
* ConvTranspose `v` [k, out, in]      -> `v` [in, out, k]     (same transpose)
* 2-D conv `kernel` / `v` [kh, kw, in, out] -> [out, in, kh, kw]
* weight-norm `g` [1, .., 1, n]       -> `g` [n, 1, .., 1]
* HuBERT `conv_{i}_kernel`            -> `conv_{i}.weight`
* `embedding`, LayerNorm `scale` / `gamma` -> `weight`;  `beta` -> `bias`
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vcvits_tpu_torch.config import Config

_HUBERT_CONV = re.compile(r"^conv_(\d+)_(kernel|bias)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def _convert_leaf(path: str, arr: np.ndarray):
    parent, _, leaf = path.rpartition(".")
    pre = parent + "." if parent else ""
    m = _HUBERT_CONV.match(leaf)
    if m:
        i, kind = m.groups()
        name = f"{pre}conv_{i}.{'weight' if kind == 'kernel' else 'bias'}"
        return name, arr.transpose(2, 1, 0) if kind == "kernel" else arr
    if leaf in ("kernel", "v"):
        name = pre + ("weight" if leaf == "kernel" else "v")
        if arr.ndim == 2:
            return name, arr.T
        if arr.ndim == 4:
            return name, arr.transpose(3, 2, 0, 1)
        return name, arr.transpose(2, 1, 0)
    if leaf == "g":
        return pre + "g", arr.reshape(-1, *([1] * (arr.ndim - 1)))
    if leaf in ("embedding", "scale", "gamma"):
        return pre + "weight", arr
    if leaf == "beta":
        return pre + "bias", arr
    return path, arr


def _convert_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(tree).items():
        name, val = _convert_leaf(path, arr)
        if name in sd:
            raise ValueError(f"two JAX leaves map to the port parameter {name}")
        sd[name] = torch.tensor(np.ascontiguousarray(val), dtype=torch.float32)
    return sd


def params_from_jax(g_params: Mapping, cfg: Optional[Config] = None) -> Dict[str, torch.Tensor]:
    """Numpy JAX parameter tree -> float32 state dict. With `cfg`, the tree
    must be a whole generator of that configuration (checked on the decoder
    input, the upsampler width and the speaker table)."""
    sd = _convert_tree(g_params)
    if cfg is not None:
        m = cfg.model
        expect = {"dec.conv_pre.v": (m.upsample_initial_channel, m.inter_channels, 7)}
        if cfg.data.n_speakers >= 1:
            expect["emb_g.weight"] = (cfg.data.n_speakers, m.gin_channels)
        for name, shape in expect.items():
            got = tuple(sd[name].shape) if name in sd else None
            if got != shape:
                raise ValueError(f"{name}: expected {shape} for this config, got {got}")
    return sd


def disc_params_from_jax(d_params: Mapping) -> Dict[str, torch.Tensor]:
    """Numpy {"mpd": ..., "msd": ...} discriminator tree -> float32 state
    dict of the port's `Discriminators` (keys `mpd.*`, `msd.*`)."""
    if set(d_params) != {"mpd", "msd"}:
        raise ValueError(f"expected the keys mpd and msd, got {sorted(d_params)}")
    return _convert_tree(d_params)


_MULTI_STEPS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads"}


def _find_state(opt_state: Any, fields) -> Optional[Dict[str, Any]]:
    """The first node of an optax state that has every field of `fields`, as
    a dict. Namedtuples are walked by their field names, tuples in order
    (optax's chain) and mappings by key (an Orbax step restored as numpy),
    so no optax import is needed. A MultiStepsState's `acc_grads`, a tree
    shaped like the parameters, is not searched."""
    if hasattr(opt_state, "_fields"):
        node = {f: getattr(opt_state, f) for f in opt_state._fields}
    elif isinstance(opt_state, Mapping):
        node = dict(opt_state)
    elif isinstance(opt_state, (tuple, list)):
        node = dict(enumerate(opt_state))
    else:
        return None
    if set(fields) <= set(node):
        return node
    for key, child in node.items():
        if key == "acc_grads" and _MULTI_STEPS <= set(node):
            continue
        found = _find_state(child, fields)
        if found is not None:
            return found
    return None


def _adam_state(opt_state: Any) -> Optional[Dict[str, Any]]:
    """{"count", "mu", "nu"} of the ScaleByAdamState inside an optax state
    (inside a MultiStepsState, its `inner_opt_state`'s)."""
    return _find_state(opt_state, ("count", "mu", "nu"))


def _arrays_only(tree: Mapping) -> Dict:
    """The tree without optax's masked leaves (MaskedNode, no shape): the
    frozen HuBERT has no moments."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            sub = _arrays_only(v)
            if sub:
                out[k] = sub
        elif hasattr(v, "shape"):
            out[k] = v
    return out


def _moments(opt_state: Any, convert) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax Adam (count, mu, nu) -> AdamW's per-parameter state by port
    name: exp_avg, exp_avg_sq and step (float32, as torch keeps it)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    mu, nu = convert(_arrays_only(adam["mu"])), convert(_arrays_only(adam["nu"]))
    count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    return {name: {"step": count.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for name in mu}


def _accumulator(step: int, g_opt_state: Any, d_opt_state: Any) -> Dict[str, Any]:
    """The port's "accum" entry: from optax.MultiSteps' states (mini_step,
    gradient_step as the update count, acc_grads as the running means),
    or, without accumulation, none pending and one update a step."""
    g_ms, d_ms = (_find_state(s, tuple(_MULTI_STEPS)) for s in (g_opt_state, d_opt_state))
    if g_ms is None or d_ms is None:
        return {"mini_step": 0, "updates": step, "g": {}, "d": {}}
    return {"mini_step": int(np.asarray(g_ms["mini_step"])),
            "updates": int(np.asarray(g_ms["gradient_step"])),
            "g": _convert_tree(_arrays_only(g_ms["acc_grads"])),
            "d": _convert_tree(_arrays_only(d_ms["acc_grads"]))}


def train_state_from_jax(state: Any, cfg: Optional[Config] = None) -> Dict[str, Any]:
    """A JAX GANTrainState with numpy leaves (`jax.tree.map(np.asarray,
    state)`, or an Orbax step restored as numpy) -> the port's checkpoint
    content: {"step", "gen", "disc", "g_opt", "d_opt", "accum"}, the layout
    of `TrainStep.state_dict()`. optax's mu / nu / count become AdamW's
    exp_avg / exp_avg_sq / step; HuBERT, masked out of optax, has none.
    Under gradient accumulation the Adam state is MultiSteps'
    `inner_opt_state`, and mini_step, gradient_step and acc_grads become
    the accumulator. With `cfg`, the generator is checked against that
    configuration."""
    get = (lambda k: state[k]) if isinstance(state, Mapping) else (lambda k: getattr(state, k))
    step = int(np.asarray(get("step")))
    return {"step": step,
            "gen": params_from_jax(get("g_params"), cfg),
            "disc": disc_params_from_jax(get("d_params")),
            "g_opt": _moments(get("g_opt_state"), _convert_tree),
            "d_opt": _moments(get("d_opt_state"), _convert_tree),
            "accum": _accumulator(step, get("g_opt_state"), get("d_opt_state"))}


def tts_train_state_from_jax(state: Any, cfg: Optional[Config] = None) -> Dict[str, Any]:
    """`train_state_from_jax` of a TTS run's GANTrainState (a SynthesizerTTS
    generator with `(g_params, d_params)` and their optimizer states, as
    vcvits_tpu/train/tts_trainer.py checkpoints it) -> the content of
    `TTSTrainStep.state_dict()`. Raises when the generator is not a TTS
    one."""
    out = train_state_from_jax(state, cfg)
    if "enc_p.emb.weight" not in out["gen"] or "duration_predictor.pre.weight" not in out["gen"]:
        raise ValueError("not a SynthesizerTTS generator: no enc_p.emb or duration_predictor")
    return out
