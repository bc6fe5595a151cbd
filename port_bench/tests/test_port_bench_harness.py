"""The harness on the CPU at tiny sizes: a cell added as files alone is
found and run, the last line has the result's shape, and a run whose timed
path is broken underneath comes out not correct."""

from __future__ import annotations

import argparse
import json
import os

import pytest
import torch

from conftest import add_cell
from port_bench import harness, run

SEED = 2**31 + 12345
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
GEN_LIMITS = {"decode_gap_A": 1e-3, "reconstruction_gap_A": 2e-3, "cartesian_gap_A": 0.05,
              "torsion_gap_A": 1e-5, "ensemble_gap_A": 5e-4}
READER = '''"""Steps the window ran (a test's metric, added as a file)."""


def read(rec):
    return float(rec["steps"]) if rec.get("kind") == "train" else None
'''


def _run(root: str, cell: str, trace: int = 0, seconds: float = 1.0) -> tuple:
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds, trace=trace)
    line, notes = run.execute(args, device="cpu", root=root)
    return json.loads(line), notes


@pytest.fixture
def train_root(tiny_root):
    with open(os.path.join(tiny_root, "port_bench", "metrics", "steps_run.train.py"), "w") as f:
        f.write(READER)
    add_cell(tiny_root, "train-tiny", "pev-tiny", "pairs-tiny", TRAIN_LIMITS,
             metric="steps_run.train")
    return tiny_root


@pytest.fixture
def gen_root(tiny_root):
    add_cell(tiny_root, "gen-tiny", "pev-tiny", "polish-tiny", GEN_LIMITS)
    return tiny_root


@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell_added_as_files_runs(train_root, trace):
    out, notes = _run(train_root, "train-tiny", trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert out["metrics"]["steps_run.train"]["value"] == out["attempted"]
        assert {"mfu_pct.train", "step_call_ms.train", "collate_ms.train"} <= set(out["metrics"])
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    else:
        assert set(out["metrics"]) == {"train_residues_per_s", "setup_s"}
        assert out["metrics"]["train_residues_per_s"]["value"] > 0
    assert [n.split(":")[0] for n in notes[-len(out["checks"]):]] == [
        f"check {k}" for k in out["checks"]]


def test_result_line_shape(train_root):
    out, notes = _run(train_root, "train-tiny")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(n.startswith(f"check {name}:") for n in notes)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_gen_cell_added_as_files_runs(gen_root):
    out, _ = _run(gen_root, "gen-tiny")
    assert out["correct"], out["checks"]
    assert out["metrics"]["gen_residues_per_s"]["value"] > 0


# -- faults planted under the timed path ----------------------------------

def _no_update(self, state, g, lr, tp_sum=None):
    return torch.sqrt(torch.dot(g, g))


def _half_batch(make_loss_fn):
    def make(model, weights, dp_sum=None):
        inner = make_loss_fn(model, weights, dp_sum)

        def loss_fn(batch, klw_g, klw_l, eps=None):
            h = batch["tgt"]["mask"].shape[0] // 2
            return inner({s: {f: t[:h] for f, t in d.items()} for s, d in batch.items()},
                         klw_g, klw_l, eps)
        return loss_fn
    return make


def test_train_state_unchanged_is_not_correct(train_root, monkeypatch):
    from protein_ensemble_vae_torch.train import training

    monkeypatch.setattr(training.Optimizer, "apply", _no_update)
    out, _ = _run(train_root, "train-tiny")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


def test_train_half_batch_is_not_correct(train_root, monkeypatch):
    from protein_ensemble_vae_torch.train import training

    monkeypatch.setattr(training, "make_loss_fn", _half_batch(training.make_loss_fn))
    out, _ = _run(train_root, "train-tiny")
    assert not out["correct"]


def test_gen_refinement_unchanged_is_not_correct(gen_root, monkeypatch):
    from protein_ensemble_vae_torch.infer import generate

    same = lambda n, ca, c, mask, **kw: (n.clone(), ca.clone(), c.clone())  # noqa: E731
    monkeypatch.setattr(generate, "refine_backbone", same)
    monkeypatch.setattr(generate, "refine_torsions", same)
    out, _ = _run(gen_root, "gen-tiny")
    assert not out["correct"]
    for k in ("cartesian_gap_A", "torsion_gap_A", "ensemble_gap_A"):
        assert out["checks"][k]["value"] > out["checks"][k]["limit"], k


def test_gen_answer_altered_is_not_correct(gen_root, monkeypatch):
    from protein_ensemble_vae_torch.models.decoder import EGNNDecoder

    inner = EGNNDecoder.forward

    def shifted(self, z_g, z_l, mask=None):
        n, ca, c, seq = inner(self, z_g, z_l, mask)
        return n, ca + 0.01, c, seq

    monkeypatch.setattr(EGNNDecoder, "forward", shifted)
    out, _ = _run(gen_root, "gen-tiny")
    assert not out["correct"]
    assert out["checks"]["decode_gap_A"]["value"] > out["checks"]["decode_gap_A"]["limit"]


def test_gen_half_the_samples_is_not_correct(gen_root, monkeypatch):
    from protein_ensemble_vae_torch.infer import generate

    inner = generate.generate_ensembles

    def half(*args, num_samples=10, **kwargs):
        return inner(*args, num_samples=num_samples // 2, **kwargs)

    monkeypatch.setattr(generate, "generate_ensembles", half)
    out, _ = _run(gen_root, "gen-tiny")
    assert not out["correct"]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    assert "protein_ensemble_vae_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", types.ModuleType("jaxlib_lookalike"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
