"""What one rank holds of a sharded train step, and the operators that keep
that step equal to the single-process step.

The JAX package states its layout as shardings and lets XLA's SPMD insert
every collective; here each rank is a process and the model says where the
collectives go:

- ``TP``: a rank's place in its tensor-parallel group.
- ``tp_param_dim``: the Megatron layout by the port's parameter names, the
  table of the JAX package's ``parallel/mesh.py:_tp_spec_for`` carried
  through ``models/bridge.py``'s layouts (a torch ``Linear`` weight is
  ``[out, in]`` where a Flax kernel is ``[in, out]``; attention q/k/v are
  ``[heads * head_dim, d]``). Biases stay whole on every rank.
- Megatron's conjugate pair: ``copy_to_tp`` (identity forward, all-reduce
  backward) where a replicated tensor enters a column-parallel product, and
  ``reduce_from_tp`` (all-reduce forward, identity backward) after a
  row-parallel product. A column-parallel layer's whole bias enters through
  ``copy_to_tp`` too, so every replicated parameter gets the same, whole
  gradient on every tp rank.
- Random draws at the global shape: ``Dropout`` and ``randn`` draw the
  global batch's tensor (and, under tp, all heads or hidden columns) from
  the step's seed, the same on every rank, and keep this rank's rows and
  columns. So a dp x tp step draws the single-process step's bits.
  ``draw_rows`` sets the rows a model's draws keep.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

Tensor = torch.Tensor

# port parameter name (last component) -> the dim tp shards, EGNN layers
_EGNN_DIMS = {"phi_e1_hi_kernel": 1, "phi_e1_hj_kernel": 1, "phi_e1_d2_kernel": 1,
              "phi_x1_kernel": 1, "phi_e2_kernel": 0, "phi_x2_kernel": 0}
_ATTENTION = ("self_attn", "geometric_attention", "global_attention")


def tp_param_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of parameter ``name`` (of rank ``ndim``) that tp shards, or
    None where every tp rank holds it whole. Column-parallel weights shard
    their output dim, row-parallel weights their input dim."""
    parts = name.split(".")
    leaf = parts[-1]
    if ndim < 2:
        return None
    if any(p.startswith("egnn_") for p in parts):
        if leaf in _EGNN_DIMS:
            return _EGNN_DIMS[leaf]
        if leaf == "weight" and "phi_h1" in parts:
            return 0
        if leaf == "weight" and "phi_h2" in parts:
            return 1
        return None
    if leaf != "weight":
        return None
    if any(a in parts for a in _ATTENTION):
        if parts[-2] in ("query", "key", "value"):
            return 0
        return 1 if parts[-2] == "out" else None
    if "linear1" in parts:
        return 0
    if "linear2" in parts:
        return 1
    return None


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's index in its tensor-parallel group, the group's size and
    its process group."""

    rank: int
    size: int
    group: object

    def chunk(self, t: Tensor, dim: int) -> Tensor:
        """This rank's contiguous 1/size of ``t`` along ``dim`` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: Tensor, tp: Optional[TP]) -> Tensor:
    """Identity forward; the gradient is summed over the tp group."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: Tensor, tp: Optional[TP]) -> Tensor:
    """The partial sums of a row-parallel product, summed over the tp group;
    the gradient passes as it is."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def _draw(fn, shape, rows: tuple[int, int], tp: Optional[TP], dim: int,
          **kw) -> Tensor:
    """``fn(global shape, **kw)``, then this rank's rows and tp columns: the
    global shape has ``shape[0] * count`` rows and, under tp, ``tp.size``
    times ``shape[dim]``."""
    rank, count = rows
    full = list(shape)
    full[0] *= count
    if tp is not None:
        full[dim] *= tp.size
    u = fn(full, **kw)
    if count > 1:
        u = u.narrow(0, rank * shape[0], shape[0])
    if tp is not None:
        u = tp.chunk(u, dim)
    return u


def randn(shape, rows: tuple[int, int] = (0, 1), generator=None, device=None,
          dtype=torch.float32) -> Tensor:
    """N(0, 1) at ``shape``: rows ``rows`` of the draw at the global batch."""
    return _draw(torch.randn, shape, rows, None, 0, generator=generator,
                 device=device, dtype=dtype)


class Dropout(nn.Module):
    """Dropout whose keep mask is drawn at the global batch's shape (and all
    tp columns, for a tensor sharded along ``dim``), from torch's default
    generator of the tensor's device; ``rows`` = (this rank's row shard, the
    number of shards), (0, 1) outside a sharded step."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.rows = (0, 1)

    def forward(self, x: Tensor, tp: Optional[TP] = None, dim: int = -1) -> Tensor:
        if not self.training or self.p == 0:
            return x
        keep = _draw(_bernoulli, x.shape, self.rows, tp, dim % x.ndim, p=1.0 - self.p,
                     device=x.device)
        return (x * keep).mul_(1.0 / (1.0 - self.p))


def _bernoulli(shape, p: float, device=None) -> Tensor:
    """True with probability ``p``: one draw on the device, a bool mask
    (what the backward keeps: one byte an entry)."""
    return torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(p)


@contextlib.contextmanager
def draw_rows(model: nn.Module, rank: int, count: int):
    """Within the block, every draw of ``model`` (its ``Dropout`` modules
    and reparameterisation noise) keeps row shard ``rank`` of ``count``."""
    drawers = [m for m in model.modules() if hasattr(m, "rows")]
    for m in drawers:
        m.rows = (rank, count)
    try:
        yield
    finally:
        for m in drawers:
            m.rows = (0, 1)
