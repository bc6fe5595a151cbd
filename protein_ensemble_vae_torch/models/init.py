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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


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


def linear(in_features: int, out_features: int, bias: bool = True,
           fan_in: Optional[int] = None, kernel_scale: float = 1.0,
           zero_bias: bool = False,
           logvar_bias_z: Optional[int] = None) -> nn.Linear:
    """``nn.Linear`` with the JAX package's ``TorchLinear`` overrides."""
    lin = nn.Linear(in_features, out_features, bias=bias)
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
