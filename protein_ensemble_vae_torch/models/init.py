"""Initialisation matched to the JAX package's ``models/init.py``.

The JAX package re-creates PyTorch's ``nn.Linear`` default init in Flax
(``TorchLinear``: U(+-1/sqrt(fan_in)) for kernel and bias), so here
``nn.Linear`` keeps its own default and only the overrides are written out:

- ``fan_in``: the variance fan-in, for algebraically split matrices (the
  EGNN edge MLP's first layer uses the joint fan-in 2H+1);
- ``kernel_scale``: scales the weight distribution (``l2c_out``: 0.1);
- ``zero_bias``: bias = 0;
- ``logvar_bias_z``: bias[z:] = -2 on top of the default (latent heads).

Flax's attention blocks keep Flax's own init (``lecun_normal`` kernels,
zero bias), see ``lecun_normal_``.

Compute dtype: the parameters are fp32; ``Linear`` and ``LayerNorm`` compute
in their ``dtype`` (bf16 for a bf16 model), as ``TorchLinear(dtype=...)``
and Flax's ``LayerNorm(dtype=...)`` do:

- ``Linear`` casts its input, weight and bias to ``dtype`` on every call;
- ``LayerNorm`` takes its statistics and normalises in fp32 (Flax's
  ``force_float32_reductions``), then casts the output to ``dtype``.

With ``dtype`` fp32 both are ``nn.Linear`` / ``nn.LayerNorm`` as they are.

Tensor parallelism (``parallel/mesh.py:shard_model``): a ``Linear`` whose
weight tp shards is column-parallel (weight ``[out / tp, in]``, output
sharded) or row-parallel (weight ``[out, in / tp]``, input sharded, partial
products summed over the tp group before the bias, which is added once).
Its bias stays whole; a column-parallel layer adds its own slice of it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from protein_ensemble_vae_torch.parallel.shard import copy_to_tp, reduce_from_tp

LN_EPS = 1e-6   # Flax LayerNorm default


def uniform_(t: torch.Tensor, fan_in: int, scale: float = 1.0) -> torch.Tensor:
    """U(+-scale/sqrt(fan_in)) in place."""
    bound = scale / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound)


def lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +-2 sd, rescaled so
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


class Linear(nn.Linear):
    """``nn.Linear`` (fp32 parameters) that computes in ``dtype``; under tp
    (``tp`` set, ``tp_mode`` "column" or "row") a Megatron shard."""

    tp = None
    tp_mode: Optional[str] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        tp = self.tp
        if tp is None:
            bias = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        if self.tp_mode == "column":
            bias = tp.chunk(copy_to_tp(self.bias, tp), 0).to(dt)
            return F.linear(copy_to_tp(x, tp).to(dt), self.weight.to(dt), bias)
        y = reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)), tp)
        return y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with Flax's eps (fp32 parameters): statistics and
    normalisation in the parameters' dtype, fp32 (float64 only in a model
    cast to float64 as a reference), the output in ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype)).to(self.compute_dtype)


def layer_norm(d: int, dtype: torch.dtype = torch.float32) -> LayerNorm:
    return LayerNorm(d, dtype)


def linear(in_features: int, out_features: int, bias: bool = True,
           fan_in: Optional[int] = None, kernel_scale: float = 1.0,
           zero_bias: bool = False, logvar_bias_z: Optional[int] = None,
           dtype: torch.dtype = torch.float32) -> Linear:
    """``Linear`` (computing in ``dtype``) with the JAX package's
    ``TorchLinear`` overrides."""
    lin = Linear(in_features, out_features, bias=bias, dtype=dtype)
    fi = fan_in if fan_in is not None else in_features
    if fan_in is not None or kernel_scale != 1.0:
        uniform_(lin.weight, fi, kernel_scale)
    if bias:
        if zero_bias:
            nn.init.zeros_(lin.bias)
        elif fan_in is not None:
            uniform_(lin.bias, fi)
        if logvar_bias_z is not None:
            with torch.no_grad():
                lin.bias[logvar_bias_z:] = -2.0
    return lin
