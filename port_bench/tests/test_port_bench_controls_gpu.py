"""The controls of ``correct`` on the card at a size a test run holds (the
training cell's model on tiny pairs, a small model for polish): the
reference computed one precision lower in the program's place fails a
number of each cell's limits, on three seeds. Marked ``gpu``: skips without a CUDA device."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import TINY_MODEL, add_cell
from port_bench import harness

SMALL = dict(TINY_MODEL, seqemb_dim=256, d_model=256, nhead=8, ff=512, nlayers=2,
             z_global=128, z_local=64, decoder_hidden=128, decoder_layers=2, max_neighbors=16)
SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.fixture
def small_root(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the controls need TF32 products on the card")
    with open(os.path.join(tiny_root, "port_bench", "configs", "pev-tiny.json"), "w") as f:
        json.dump(dict(name="pev-tiny", model=SMALL), f)
    return tiny_root


@pytest.mark.gpu
def test_train_control_fails_a_limit(small_root):
    """The width-512 cell's model on the tiny pairs (at the small model the
    TF32 control reads under the cell's limits: the limits are the cell's)."""
    from port_bench.controls import train

    with open(os.path.join(harness.PKG_DIR, "limits", "train-hd512-b16.json")) as f:
        limits = json.load(f)
    add_cell(small_root, "train-small", "pev-hd512", "pairs-tiny", limits)
    cell = harness.load_cell(small_root, "train-small")
    for seed in SEEDS:
        r = train.readings(cell, seed, torch.device("cuda:0"))
        assert _fails(r["control_tf32"], limits), r
        assert _fails(r["fault_half_batch"], limits), r


@pytest.mark.gpu
def test_gen_control_fails_a_limit(small_root):
    from port_bench.controls import generate

    with open(os.path.join(harness.PKG_DIR, "limits", "gen-polish-default.json")) as f:
        limits = json.load(f)
    add_cell(small_root, "gen-small", "pev-tiny", "polish-tiny", limits)
    cell = harness.load_cell(small_root, "gen-small")
    for seed in SEEDS:
        r = generate.readings(cell, seed, torch.device("cuda:0"))
        assert _fails(r["control"], limits), r
