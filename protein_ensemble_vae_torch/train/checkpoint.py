"""Checkpoints of the port: ``state.pt`` + ``meta.json``.

Layout on disk:
    <path>/state.pt     the model's ``state_dict`` (``torch.save``)
    <path>/meta.json    {"epoch", "config": RunConfig, "format_version"} —
                        the same ``config`` block as the JAX package's
                        checkpoints ("architecture travels with the
                        checkpoint")

Only what generation needs: ``save_checkpoint`` (used to carry bridged
weights over, and by the tests), ``load_run_config`` and
``load_checkpoint``.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from protein_ensemble_vae_torch.config import RunConfig

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def save_checkpoint(path: str, model: nn.Module, run_config: RunConfig,
                    epoch: int = 0) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, STATE_FILE))
    meta = {"epoch": int(epoch), "config": json.loads(run_config.to_json()),
            "format_version": 1}
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_meta(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), META_FILE)) as f:
        return json.load(f)


def load_run_config(path: str) -> RunConfig:
    return RunConfig.from_json(json.dumps(load_meta(path)["config"]))


def load_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load ``<path>/state.pt`` into ``model`` (strict: every key must
    match) on the device the model lies on."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                       map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
