"""Seeded weights for the port's ``HierCVAE``, made by the benchmark on the
device in two large draws, keyed by the port's parameter names (which the
reference shares).

The distributions follow the port's own initialisation, so the weights are
of a trained model's scale without being the program's: a ``Linear``'s
weight and bias U(+-1/sqrt(fan_in)); attention projections of the same
variance with zero bias; the EGNN edge weights U(+-1/sqrt(fan_in)), the
split first layer at its joint fan-in 2H + 1; LayerNorm scales 1 and
offsets 0; the latent heads' log-variance biases -2; the coordinate head
scaled by 0.1 with zero bias; the geometric attention's residual scale 0.1.
"""

from __future__ import annotations

import math

import torch

_ATTENTION = ("query", "key", "value", "out")


def _rule(name: str, shape: tuple, shapes: dict) -> tuple:
    """(kind, bound) of a parameter: kind "u" is U(+-bound), "c" the
    constant ``bound``, "lv" U(+-bound) with the second half -2."""
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if leaf == "geom_res_scale":
        return "c", 0.1
    if leaf == "global_query":
        return "u", 0.02 * math.sqrt(3.0)
    if "norm" in owner:
        return "c", 1.0 if leaf == "weight" else 0.0
    if leaf.startswith("phi_"):           # EGNN raw edge weights, [in, out]
        layer = ".".join(parts[:-1])
        if leaf.startswith("phi_e1"):
            fan = 2 * shapes[layer + ".phi_e1_hi_kernel"][0] + 1
        elif leaf.endswith("_kernel"):
            fan = shape[0]
        else:
            fan = shapes[layer + "." + leaf.replace("_bias", "_kernel")][0]
        return "u", 1.0 / math.sqrt(fan)
    fan = shapes[".".join(parts[:-1]) + ".weight"][1]
    if owner in _ATTENTION:
        return ("u", math.sqrt(3.0 / fan)) if leaf == "weight" else ("c", 0.0)
    if owner == "l2c_out":
        return ("u", 0.1 / math.sqrt(fan)) if leaf == "weight" else ("c", 0.0)
    if leaf == "bias" and owner in ("global_out", "local_out"):
        return "lv", 1.0 / math.sqrt(fan)
    return "u", 1.0 / math.sqrt(fan)


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: fp32 tensor} for the parameters ``shapes`` ({name: shape}),
    drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind, b = _rule(name, shape, shapes)
        if kind == "c":
            t = torch.full(shape, b, device=device)
        else:
            t = (draw[off:off + n] * b).view(shape)
            if kind == "lv":
                t[shape[0] // 2:] = -2.0
        out[name] = t
        off += n
    return out
