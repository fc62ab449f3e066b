"""JAX parameter trees -> the port's state dicts, leaf by leaf.

Every leaf of a JAX generator tree (enc_q included) and of a JAX
discriminator tree lands on exactly one parameter of the port's module,
with the same number of values, and every port parameter is reached.
"""

import jax
import numpy as np
import pytest
import torch

from vcvits_tpu.config import Config as JaxConfig
from vcvits_tpu.models.hubert import HubertConfig as JaxHubertConfig
from vcvits_tpu.train.step import init_params
from vcvits_tpu_torch.config import Config
from vcvits_tpu_torch.convert.from_jax import disc_params_from_jax, params_from_jax
from vcvits_tpu_torch.models.discriminators import Discriminators
from vcvits_tpu_torch.models.hubert import HubertConfig
from vcvits_tpu_torch.models.synthesizer import SynthesizerSVC

HUBERT = dict(conv_layers=((16, 10, 5), (16, 8, 8), (16, 8, 8)), hidden_size=16, num_layers=1,
              num_heads=2, intermediate_size=32, pos_conv_kernel=8, pos_conv_groups=2)
CFG = {"train": {"segment_size": 2048},
       "data": {"filter_length": 1024, "win_length": 1024, "n_mel_channels": 8,
                "n_speakers": 8},
       "model": {"inter_channels": 8, "hidden_channels": 16, "filter_channels": 32,
                 "n_heads": 2, "n_layers": 1, "hubert_channels": 16, "num_pitch": 64,
                 "gin_channels": 4, "upsample_initial_channel": 32,
                 "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1]],
                 "multi_period_discriminator_periods": [2, 3]}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def trees():
    batch = {"x_wav": np.zeros((1, 5120), np.float32), "x_wav_lengths": np.array([5120]),
             "x_pitch": np.zeros((1, 16), np.int32), "y_wav": np.zeros((1, 15360), np.float32),
             "y_wav_lengths": np.array([15360]), "sid": np.array([1])}
    return jax.eval_shape(lambda: init_params(JaxConfig.from_dict(CFG), jax.random.PRNGKey(0),
                                              batch, hubert_cfg=JaxHubertConfig(**HUBERT)))


@pytest.mark.parametrize("side", ["generator", "discriminators"])
def test_every_leaf_lands_on_one_parameter(trees, side):
    cfg = Config.from_dict(CFG)
    if side == "generator":
        tree = trees[0]
        module = SynthesizerSVC.from_config(cfg, device="cpu", seed=None,
                                            hubert_cfg=HubertConfig(**HUBERT))
        convert = params_from_jax
    else:
        tree = trees[1]
        module = Discriminators.from_config(cfg)
        convert = disc_params_from_jax
    leaves = dict(_leaves(tree))
    assert any(k.startswith("enc_q.") for k in leaves) or side != "generator"
    # a distinct value per leaf, to see where each one lands
    numbered = {}
    for i, (path, leaf) in enumerate(leaves.items()):
        numbered[path] = np.full(leaf.shape, float(i), np.float32)
    nested = {}
    for path, arr in numbered.items():
        node = nested
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr
    sd = convert(nested)
    params = dict(module.named_parameters())
    assert set(sd) == set(params)  # every parameter reached, nothing extra
    landed = {}
    for name, t in sd.items():
        vals = torch.unique(t)
        assert vals.numel() == 1 and t.shape == params[name].shape, name
        landed.setdefault(int(vals.item()), []).append(name)
    assert sorted(landed) == list(range(len(leaves)))
    assert all(len(names) == 1 for names in landed.values())
    module.load_state_dict(sd)
