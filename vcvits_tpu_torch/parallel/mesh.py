"""The ('data', 'model') layout on torch.distributed: process groups, batch
rows, the tensor-parallel rule and the placement of parameters (the port's
counterpart of vcvits_tpu/parallel/mesh.py).

One process per rank (torchrun, or spawned), NCCL on CUDA and gloo on the
CPU. JAX is a single controller with a `Mesh` of devices; here a `Mesh`
holds this rank's place in a data x model grid of ranks (the model index
the fast one, as JAX's `reshape(data, model)`) and two groups:

* the data group (the ranks sharing this rank's model index): each holds
  its own rows of the global batch, and gradients, metrics and the KL's
  mask sum are all-reduced (SUM) over it, so every loss is the global
  batch's as under JAX's psum;
* the model group (the ranks sharing this rank's data index): the layers
  that `tp_spec` marks hold a contiguous slice of one axis, and the
  operators of parallel/tp.py join their outputs. The numbers are the
  unsharded model's, as JAX's tensor sharding is only a placement.

Collectives are all_reduce and all_gather only.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vcvits_tpu_torch.parallel.tp import Shard, gather, local_slice
from vcvits_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def distributed_init(**kwargs) -> bool:
    """init_process_group from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or from explicit kwargs
    (init_method, world_size, rank, backend, timeout in seconds). Returns
    True when a process group is up.

    A genuine failure (a bad address, a timeout, a wrong world size)
    raises: silently training on one process would be worse. The benign
    cases, as in JAX's distributed_init:

    * ``VCVITS_NO_DISTRIBUTED=1`` skips init entirely;
    * an already-initialised group is a no-op;
    * no cluster environment and no kwargs is a single-process run.

    The backend is NCCL when CUDA is available and gloo otherwise (the
    `backend` kwarg overrides: gloo lets two ranks share one card). Under
    NCCL each rank takes cuda:LOCAL_RANK.
    """
    if os.environ.get("VCVITS_NO_DISTRIBUTED") == "1":
        return False
    if dist.is_initialized():
        return True
    if not kwargs and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    backend = kwargs.pop("backend", None) or ("nccl" if torch.cuda.is_available() else "gloo")
    if "timeout" in kwargs and not isinstance(kwargs["timeout"], timedelta):
        kwargs["timeout"] = timedelta(seconds=float(kwargs["timeout"]))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend=backend, **kwargs)
    if dist.get_world_size() > 1:
        logger.info("distributed init ok: rank %d of %d (%s)", dist.get_rank(),
                    dist.get_world_size(), backend)
    return True


def local_device(default: str = "cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK when the default is the card and
    a process group spans several cards, else `default`."""
    dev = torch.device(default)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class Mesh:
    """This rank's place in a data x model grid of ranks. `rank` is its
    index in the grid (data-major), -1 for a rank the grid leaves out;
    `data_group` / `model_group` / `group` (the whole grid) are None where
    the group is the world or a single process."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    group: Optional[object] = None

    @property
    def active(self) -> bool:
        return self.rank >= 0

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """The rank that writes logs, config.json and checkpoints."""
        return self.rank == 0

    @property
    def size(self) -> int:
        return self.data * self.model

    def shard(self, kind: str) -> Shard:
        return Shard(self.model_group, self.model_rank, self.model, kind)

    # ------------------------------------------------------------ collectives
    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the data group (a new tensor; no graph)."""
        if self.data == 1:
            return t
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, group=self.data_group)
        return t

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        if self.model == 1:
            return t
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, group=self.model_group)
        return t

    @torch.no_grad()
    def sum_grads(self, params: Iterable[nn.Parameter]) -> None:
        """Every present `.grad` summed over the data group in place, one
        all_reduce per dtype (the psum JAX inserts per step), inside the
        program span "vcvits.train.grad_sum" (none at data 1)."""
        if self.data == 1:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        with span("train.grad_sum"):
            for grads in by_dtype.values():
                flat = torch.cat([g.reshape(-1) for g in grads])
                dist.all_reduce(flat, group=self.data_group)
                off = 0
                for g in grads:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()

    def sum_metrics(self, metrics: Mapping[str, torch.Tensor],
                    keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """Each 0-dim metric summed over the data group, one all_reduce;
        the names in `keep` (already global) pass through."""
        if self.data == 1:
            return dict(metrics)
        names = [k for k in metrics if k not in keep]
        if not names:
            return dict(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
        dist.all_reduce(flat, group=self.data_group)
        out = dict(metrics)
        out.update({k: flat[i] for i, k in enumerate(names)})
        return out

    def agree(self, flag: bool) -> bool:
        """True on every rank of the grid when it is True on any (an
        all_reduce MAX): a stop one rank sees is taken by all at the same
        step boundary, so none is left waiting in a collective."""
        if self.size == 1:
            return bool(flag)
        device = "cuda" if dist.get_backend(self.group) == "nccl" else "cpu"
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def _world() -> tuple:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A data x model grid over `ranks` (all ranks by default), as JAX's
    make_mesh over devices: `data` defaults to len(ranks) // model and
    data * model must equal len(ranks). Every rank of the world must call
    it with the same arguments (process groups are made collectively); a
    rank outside `ranks` gets rank -1."""
    world, me = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} ranks")
    grid = np.array(ranks).reshape(data, model)
    mesh = Mesh(data, model, ranks.index(me) if me in ranks else -1)
    if world == 1:
        return mesh
    for m in range(model):
        members = grid[:, m].tolist()
        g = dist.new_group(members) if len(members) < world else None
        if me in members:
            mesh.data_group = g
    for d in range(data):
        members = grid[d].tolist()
        g = dist.new_group(members) if len(members) < world else None
        if me in members:
            mesh.model_group = g
    mesh.group = dist.new_group(ranks) if n < world else None
    return mesh


def training_mesh(batch_size: int, model_parallel: int = 1) -> Mesh:
    """The trainers' grid, as JAX's Trainer picks its mesh: `model_parallel`
    ranks a model group, and as many data ranks as the global batch admits,
    gcd(batch_size, world / model_parallel), with a warning when ranks are
    left over (they get rank -1 and do not train). Raises when
    model_parallel does not divide the world."""
    world, _ = _world()
    mp = max(int(model_parallel), 1)
    if world % mp:
        raise ValueError(f"model_parallel={mp} does not divide {world} ranks")
    data = math.gcd(int(batch_size), world // mp)
    if data * mp < world:
        logger.warning("using %d-way data x %d-way model parallelism on %d of %d ranks",
                       data, mp, data * mp, world)
    return make_mesh(data, mp, ranks=range(data * mp))


def shard_batch(batch: Mapping, mesh: Mesh) -> Dict:
    """This rank's contiguous rows of a global batch: rank r of the data
    group takes rows [r * B / d, (r + 1) * B / d) of every leaf (NumPy
    arrays or tensors)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch of {b} rows does not split over {mesh.data} data ranks")
        n = b // mesh.data
        out[k] = v[mesh.data_rank * n:(mesh.data_rank + 1) * n]
    return out


# ------------------------------------------------------- tensor parallelism

def tp_spec(name: str, shape: Sequence[int]) -> Optional[int]:
    """The axis of a port parameter that JAX's `_tp_spec`
    (vcvits_tpu/parallel/mesh.py:90-111) shards over 'model', in PyTorch
    layout, or None (replicated):

    * HuBERT's q/k/v/fc1 weights [out, in] and biases on their output
      axis (0); out_proj/fc2 weights [out, in] on their input axis (1);
    * a 1-D or 2-D conv kernel (`v` of a weight-normed conv, or `weight`)
      whose flax kernel's last axis is at least 512 wide, on that axis: a
      conv's output channels (torch dim 0 of [out, in/g, k] and [out, in,
      kh, kw]) and a transposed conv's input channels (torch dim 0 of [in,
      out, k]; flax stores [k, out, in]). HuBERT's feature-extractor convs
      (flax `conv_{i}_kernel`) are not among them. Weight-norm `g`s and
      the other biases stay replicated.
    """
    parts = name.split(".")
    leaf, ndim = parts[-1], len(shape)
    if any(k in name for k in ("q_proj", "k_proj", "v_proj", "fc1")):
        if leaf == "weight" and ndim == 2:
            return 0
        if leaf == "bias" and ndim == 1:
            return 0
    if any(k in name for k in ("out_proj", "fc2")):
        if leaf == "weight" and ndim == 2:
            return 1
    if "feature_extractor" in parts:
        return None
    if ndim in (3, 4) and leaf in ("v", "weight") and shape[0] >= 512:
        return 0
    return None


def shard_params_tp(module: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Place `module`'s parameters by `tp_spec` over the model group: each
    sharded parameter keeps this rank's contiguous slice (the Parameter
    object stays, so optimizers and their state follow it, as optax's
    zeros_like follows JAX's placement), and its layer gets a `Shard` in
    `tp` that routes its forward through parallel/tp.py. Returns the
    {name: axis} map (empty at model = 1). Raises for what the sharded
    layers cannot compute: a grouped conv whose groups do not split
    evenly, HuBERT heads that do not, a spectral-normed or int8 conv."""
    if mesh.model == 1:
        return {}
    from vcvits_tpu_torch.models.hubert import SelfAttention
    from vcvits_tpu_torch.models.layers import Conv1d, Conv2dNorm, ConvTranspose1d, Linear

    specs = {n: d for n, p in module.named_parameters()
             if (d := tp_spec(n, p.shape)) is not None}
    owners: Dict[str, Dict[str, int]] = {}
    for name, dim in specs.items():
        path, _, leaf = name.rpartition(".")
        owners.setdefault(path, {})[leaf] = dim
    for path, leaves in owners.items():
        layer = module.get_submodule(path)
        if isinstance(layer, Linear):
            kind = "col" if leaves["weight"] == 0 else "row"
        elif isinstance(layer, ConvTranspose1d):
            kind = "row"
        elif isinstance(layer, (Conv1d, Conv2dNorm)):
            kind = "col"
            groups = getattr(layer, "groups", 1)
            if groups > 1 and groups % mesh.model:
                raise ValueError(f"{path}: {groups} groups do not split over {mesh.model} "
                                 "model ranks")
        else:
            raise TypeError(f"{path}: no tensor-parallel rule for {type(layer).__name__}")
        if getattr(layer, "spectral_norm", False):
            raise NotImplementedError(f"{path}: a spectral-normed conv under tensor "
                                      "parallelism needs sigma of the whole weight; set "
                                      "use_spectral_norm false or model_parallel 1")
        if getattr(layer, "quant_int8", False):
            raise NotImplementedError(f"{path}: the int8 decoder does not run under tensor "
                                      "parallelism")
        with torch.no_grad():
            for leaf, dim in leaves.items():
                p = getattr(layer, leaf)
                p.data = local_slice(p.data, dim, mesh.model_rank, mesh.model).clone()
        layer.tp = mesh.shard(kind)
        layer._folded = None
    for path, layer in module.named_modules():
        if isinstance(layer, SelfAttention) and getattr(layer.q_proj, "tp", None) is not None \
                and layer.heads % mesh.model:
            raise ValueError(f"{path}: {layer.heads} heads do not split over {mesh.model} "
                             "model ranks")
    return specs


def full_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """The whole tensor of a shard (its slices gathered over the model
    group, no graph), or `t` where it is replicated."""
    if dim is None or mesh.model == 1:
        return t
    with torch.no_grad():
        return gather(t.detach(), dim, mesh.shard("col"))


def local_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor, or `t` where it is replicated."""
    if dim is None or mesh.model == 1:
        return t
    return local_slice(t, dim, mesh.model_rank, mesh.model)


def grad_sq_norm(params: Iterable[nn.Parameter], sharded: Iterable[nn.Parameter],
                 mesh: Mesh) -> torch.Tensor:
    """The float64 squared global norm of the gradients: a sharded
    parameter's squares summed over the model group once, a replicated
    one's counted once (a missing gradient counts 0)."""
    ids = {id(p) for p in sharded}
    rep, shd = [], []
    for p in params:
        if p.grad is not None:
            (shd if id(p) in ids else rep).append(
                torch.linalg.vector_norm(p.grad, dtype=torch.float64) ** 2)
    dev = next(iter(params)).device if not (rep or shd) else (rep or shd)[0].device
    total = torch.stack(rep).sum() if rep else torch.zeros((), dtype=torch.float64, device=dev)
    if shd:
        total = total + mesh.sum_model(torch.stack(shd).sum())
    return total
