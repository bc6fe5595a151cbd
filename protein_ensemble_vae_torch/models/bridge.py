"""Weight carry-over from the JAX package's Flax parameter tree.

``params_from_flax(tree, model)`` takes ``variables["params"]`` of the JAX
``HierCVAE`` as a nested dict of numpy arrays and returns this package's
``state_dict``. Module names match the Flax tree, so a parameter's path
carries over as it is; only leaf layouts change:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``; ``bias`` as is;
- attention ``query/key/value`` kernels ``[d, heads, head_dim]`` ->
  ``weight [heads*head_dim, d]``, bias ``[heads, head_dim]`` flattened;
  ``out`` kernel ``[heads, head_dim, d]`` -> ``weight [d, heads*head_dim]``;
- LayerNorm ``scale`` -> ``weight``;
- raw parameters (the EGNN edge weights, ``geom_res_scale``,
  ``global_query``) are copied as they are.

It raises on any key left over on either side, and on a shape mismatch.

``shard_params(full_state, tp_rank, tp)`` cuts a full state_dict (the port's
or one from ``params_from_flax``) to tp rank ``tp_rank``'s shards, by the tp
layout of ``parallel/shard.py:tp_param_dim``; ``gather_params(local_state,
tp)`` puts the shards of a tp group back together (a collective: every
rank of the group calls it).

``esm2_params_from_jax(tree, model)`` does the same for the JAX package's
ESM-2 params tree (``word_embeddings``, a list of ``layers``, ``final_ln``)
into ``models/esm2.ESM2``: each Linear ``kernel [in, out]`` becomes
``weight [out, in]``; LayerNorm ``weight`` / ``bias`` and the embedding
table carry over as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from protein_ensemble_vae_torch.parallel.shard import TP, tp_param_dim


def _convert(path: tuple[str, ...], node: Mapping, out: dict) -> None:
    keys = set(node)
    leaves = {k for k in keys if not isinstance(node[k], Mapping)}
    prefix = ".".join(path)
    if "kernel" in leaves:                         # Dense or attention block
        extra = leaves - {"kernel", "bias"}
        if extra:
            raise KeyError(f"unexpected leaves {sorted(extra)} under {prefix}")
        k = np.asarray(node["kernel"])
        if k.ndim == 2:
            w = k.T
        elif k.ndim == 3 and path[-1] == "out":    # [heads, head_dim, d]
            w = k.reshape(-1, k.shape[-1]).T
        elif k.ndim == 3:                          # [d, heads, head_dim]
            w = k.reshape(k.shape[0], -1).T
        else:
            raise ValueError(f"kernel of rank {k.ndim} at {prefix}")
        out[f"{prefix}.weight"] = w
        if "bias" in leaves:
            out[f"{prefix}.bias"] = np.asarray(node["bias"]).reshape(-1)
        leaves = set()
    elif "scale" in leaves:                        # LayerNorm
        extra = leaves - {"scale", "bias"}
        if extra:
            raise KeyError(f"unexpected leaves {sorted(extra)} under {prefix}")
        out[f"{prefix}.weight"] = np.asarray(node["scale"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"])
        leaves = set()
    for k in sorted(keys):
        if k in leaves:                            # raw parameter
            out[".".join(path + (k,))] = np.asarray(node[k])
        elif isinstance(node[k], Mapping):
            _convert(path + (k,), node[k], out)


def _match(flat: Mapping[str, np.ndarray], model: nn.Module,
           source: str) -> dict[str, torch.Tensor]:
    """``flat`` as ``model``'s state_dict: the same keys, the same shapes."""
    expected = model.state_dict()
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"{source} and model disagree: missing {missing}, "
                       f"left over {extra}")
    sd = {}
    for name, ref in expected.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: {source} shape {tuple(arr.shape)} -> "
                             f"model shape {tuple(ref.shape)}")
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return sd


def params_from_flax(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Flax ``params`` (nested dict of arrays) -> ``model``'s state_dict.

    Raises ``KeyError`` on a key that only one side has and ``ValueError``
    on a shape mismatch."""
    flat: dict[str, np.ndarray] = {}
    _convert((), tree, flat)
    return _match(flat, model, "Flax tree")


def esm2_params_from_jax(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX package's ESM-2 params tree -> ``models/esm2.ESM2``'s
    state_dict.

    Raises ``KeyError`` on a key that only one side has and ``ValueError``
    on a shape mismatch."""
    flat: dict[str, np.ndarray] = {}
    top = set(tree) - {"word_embeddings", "layers", "final_ln"}
    if top:
        raise KeyError(f"unexpected keys {sorted(top)} in the ESM-2 tree")
    nodes = [("word_embeddings", {"weight": tree["word_embeddings"]}),
             ("final_ln", tree["final_ln"])]
    nodes += [(f"layers.{i}.{name}", node) for i, layer in enumerate(tree["layers"])
              for name, node in layer.items()]
    for prefix, node in nodes:
        leaves = set(node)
        if "kernel" in leaves:                     # Linear
            extra = leaves - {"kernel", "bias"}
            flat[f"{prefix}.weight"] = np.asarray(node["kernel"]).T
        else:                                      # LayerNorm, embedding
            extra = leaves - {"weight", "bias"}
            flat[f"{prefix}.weight"] = np.asarray(node["weight"])
        if extra:
            raise KeyError(f"unexpected leaves {sorted(extra)} under {prefix}")
        if "bias" in leaves:
            flat[f"{prefix}.bias"] = np.asarray(node["bias"])
    return _match(flat, model, "ESM-2 tree")


def shard_params(full_state: Mapping, tp_rank: int, tp: int) -> dict:
    """Rank ``tp_rank`` of ``tp``'s shard of each entry of ``full_state``
    (name -> tensor or array): its contiguous 1/tp along the dim the tp
    layout shards, the whole entry elsewhere. Views where the input allows."""
    out = {}
    for name, v in full_state.items():
        d = tp_param_dim(name, v.ndim)
        if d is None or tp == 1:
            out[name] = v
            continue
        if v.shape[d] % tp:
            raise ValueError(f"{name}: dim {d} of {tuple(v.shape)} does not split "
                             f"into {tp} shards")
        n = v.shape[d] // tp
        out[name] = (v.narrow(d, tp_rank * n, n) if isinstance(v, torch.Tensor)
                     else np.take(v, range(tp_rank * n, (tp_rank + 1) * n), axis=d))
    return out


def gather_params(local_state: Mapping[str, torch.Tensor], tp: TP
                  ) -> dict[str, torch.Tensor]:
    """The full tensors of a tp group's shards (``shard_params``'s inverse),
    on every rank of the group, in one all-reduce: each rank writes its
    shards into a zero buffer of the full sharded entries (an all-reduce
    runs on CUDA tensors under gloo as under NCCL)."""
    sharded = [(k, v, tp_param_dim(k, v.ndim)) for k, v in local_state.items()]
    sharded = [(k, v, d) for k, v, d in sharded if d is not None]
    out = dict(local_state)
    if not sharded:
        return out
    full_shapes = [tuple(s * (tp.size if i == d else 1) for i, s in enumerate(v.shape))
                   for _, v, d in sharded]
    sizes = [int(np.prod(s)) for s in full_shapes]
    ref = sharded[0][1]
    buf = torch.zeros(sum(sizes), dtype=ref.dtype, device=ref.device)
    fulls = [t.view(s) for t, s in zip(buf.split(sizes), full_shapes)]
    for (_, v, d), full in zip(sharded, fulls):
        tp.chunk(full, d).copy_(v)
    dist.all_reduce(buf, group=tp.group)
    for (k, _, _), full in zip(sharded, fulls):
        out[k] = full
    return out
