"""Checkpoints of the port: ``state.pt`` + ``meta.json`` + ``history.json``
(counterpart of the JAX package's ``train/checkpoint.py``).

Layout on disk:
    <path>/state.pt      {"model": the model's state_dict,
                          "train": the TrainState's optimizer moments,
                                   counters and step, or None}
    <path>/meta.json     {"epoch", "config": RunConfig, "format_version",
                          + scheduler / LR / early-stop state} -- the same
                          ``config`` block as the JAX package's checkpoints
                          ("architecture travels with the checkpoint")
    <path>/history.json  loss_history (the reference's metric names)

``record_artifact`` appends each saved checkpoint to
``<root>/artifacts.jsonl``.

Under parallelism every rank calls ``save_checkpoint``: a tp-sharded
model's shards and optimizer moments are gathered (a collective over the tp
group) and rank 0 alone writes the full parameters, so a checkpoint of a
dp x tp run loads into a single-process model. ``load_train_state`` gives
a sharded ``TrainState`` its shards of the saved moments.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from protein_ensemble_vae_torch.config import RunConfig

STATE_FILE = "state.pt"
META_FILE = "meta.json"
HISTORY_FILE = "history.json"


def _to_jsonable(obj):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def save_checkpoint(path: str, model: nn.Module, run_config: RunConfig,
                    epoch: int = 0, loss_history: Optional[dict] = None,
                    extra_meta: Optional[dict] = None, train_state=None) -> str:
    """Write ``state.pt`` (model weights, and the optimizer state when
    ``train_state`` is given), ``meta.json`` and, with ``loss_history``,
    ``history.json``. In a process group every rank calls it and rank 0
    writes (the module docstring)."""
    from protein_ensemble_vae_torch.models.bridge import gather_params

    path = os.path.abspath(path)
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    if getattr(model, "tp", None) is not None:
        weights = gather_params(weights, model.tp)
    train = train_state.optimizer_state() if train_state is not None else None
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    os.makedirs(path, exist_ok=True)
    state = {"model": {k: v.cpu() for k, v in weights.items()}, "train": train}
    torch.save(state, os.path.join(path, STATE_FILE))
    meta = {"epoch": int(epoch), "config": json.loads(run_config.to_json()),
            "format_version": 1}
    if extra_meta:
        meta.update(_to_jsonable(extra_meta))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    if loss_history is not None:
        with open(os.path.join(path, HISTORY_FILE), "w") as f:
            json.dump(_to_jsonable(loss_history), f)
    return path


def record_artifact(root: str, name: str, path: str, epoch: int,
                    metrics: Optional[dict] = None) -> str:
    """Append a checkpoint record (name, path, epoch, time, headline
    metrics) to ``<root>/artifacts.jsonl``."""
    os.makedirs(root, exist_ok=True)
    rec = {"name": name, "path": os.path.abspath(path), "epoch": int(epoch),
           "time": time.time(), "metrics": _to_jsonable(metrics or {})}
    manifest = os.path.join(root, "artifacts.jsonl")
    with open(manifest, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return manifest


def load_meta(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), META_FILE)) as f:
        return json.load(f)


def load_history(path: str) -> Optional[dict]:
    p = os.path.join(os.path.abspath(path), HISTORY_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def load_run_config(path: str) -> RunConfig:
    return RunConfig.from_json(json.dumps(load_meta(path)["config"]))


def _load_state(path: str, device) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=device, weights_only=True)


def load_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load the weights of ``<path>/state.pt`` into ``model`` (strict: every
    key must match) on the device the model lies on."""
    device = next(model.parameters()).device
    model.load_state_dict(_load_state(path, device)["model"], strict=True)
    return model


def load_train_state(path: str, train_state) -> None:
    """Load the optimizer state of ``<path>/state.pt`` into ``train_state``
    (a ``TrainState``, sharded or not); raises if the checkpoint holds
    none."""
    saved = _load_state(path, train_state.flat.device)["train"]
    if saved is None:
        raise ValueError(f"{path} holds model weights only, no optimizer state")
    train_state.load_optimizer_state(saved)
