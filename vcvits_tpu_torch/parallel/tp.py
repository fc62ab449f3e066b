"""Tensor-parallel operators over the mesh's 'model' group, as autograd
functions (the collectives XLA inserts for JAX's `('data', 'model')`
shardings, written out).

A sharded layer holds a contiguous slice of its parameter along one
axis (parallel/mesh.py:tp_spec says which) and a `Shard` naming its group:

* column-parallel (a slice of output channels): the input goes through
  `copy_to` (identity forward, all_reduce of the input gradient's partial
  sums backward), the layer computes its channels, and `gather` (all_gather
  forward, this rank's slice of the gradient backward) joins them where
  the next op needs every channel;
* row-parallel (a slice of input channels): `split` takes this rank's
  input channels (a slice forward, all_gather of the gradient backward),
  the layer computes a partial output, and `reduce_from` (all_reduce
  forward, identity backward) sums the partials.

Only all_reduce and all_gather are used (gloo gathers host copies of CUDA
tensors, for two ranks sharing one card). A group of size 1 makes every
op the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """A sharded layer's place on the 'model' axis: its process group (None
    when the whole world is the group), this rank's index and the group's
    size, and the layer's kind ("col" or "row")."""

    group: Optional[object]
    rank: int
    size: int
    kind: str


def _all_reduce(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=shard.group)
    return t


def _all_gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    dev = t.device
    if dev.type == "cuda" and dist.get_backend(shard.group) == "gloo":
        t = t.cpu()  # gloo gathers host tensors (two ranks sharing one card)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim=dim).to(dev)


def _local(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    n = t.shape[dim]
    if n % shard.size:
        raise ValueError(f"axis of {n} does not split over {shard.size} ranks")
    k = n // shard.size
    return t.narrow(dim, shard.rank * k, k)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _all_gather(x, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return _local(grad, ctx.dim, ctx.shard).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _local(x, dim, shard).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.shard), None, None


def copy_to(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Identity forward; the input gradient summed over the group backward."""
    return x if shard.size == 1 else _CopyTo.apply(x, shard)


def reduce_from(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Partial outputs summed over the group; identity backward."""
    return x if shard.size == 1 else _ReduceFrom.apply(x, shard)


def gather(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """Every rank's slice along `dim`, concatenated in rank order; this
    rank's slice of the gradient backward. Also the gather of a whole weight
    from its shards (a fused kernel that takes whole weights)."""
    return x if shard.size == 1 else _Gather.apply(x, dim % x.ndim, shard)


def split(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """This rank's contiguous slice along `dim` of a replicated tensor; the
    gradient's slices gathered backward, so the replicated tensor gets its
    whole gradient on every rank."""
    return x if shard.size == 1 else _Split.apply(x, dim % x.ndim, shard)


def local_slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s contiguous slice of `t` along `dim` (no graph)."""
    return _local(t, dim, Shard(None, rank, size, "col"))
