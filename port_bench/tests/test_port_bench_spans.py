"""The program's spans in the traced window: the port records them under
the run's profiler, ``reduce_trace`` reads the trace as before with their
``pev::`` annotations in it, the readers of the span metrics return None
where the port's registry holds nothing or is missing (the parent commit)
and the right value on synthetic spans, and a traced CPU run of the tiny
cells reports them."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import types

import pytest
import torch

from conftest import BENCH, add_cell
from port_bench import harness, run

SEED = 2**31 + 54321
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
GEN_LIMITS = {"decode_gap_A": 1e-3, "reconstruction_gap_A": 2e-3, "cartesian_gap_A": 0.05,
              "torsion_gap_A": 1e-5, "ensemble_gap_A": 5e-4}
TRAIN_METRICS = ("fetch_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "band_host_ms.train")
GEN_METRICS = ("torsion_pct.gen", "replay_pct.gen", "refine_captures.gen")


def _event(name, start, end, device=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    """What ``reduce_trace`` reads of a profile: ``events()`` (µs)."""

    profiler = None

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


BASE = [_event("bench::window", 0, 1000), _event("bench::step_call", 60, 590),
        _event("k1", 0, 100, True), _event("k2", 300, 400, True), _event("k3", 700, 1000, True)]
PROGRAM = [_event("pev::train.step", 50, 600), _event("pev::train.forward", 150, 250),
           _event("pev::band.bwd", 500, 560),
           # the device-side copy of a host annotation is no device work
           _event("pev::train.step", 50, 600, True)]


def test_reduce_trace_reads_the_same_with_program_annotations():
    """A traced run's trace now carries the port's ``pev::`` annotations,
    host and device-side copies; the accepted reduction reads past them."""
    got = harness.reduce_trace(_Prof(BASE + PROGRAM))
    plain = harness.reduce_trace(_Prof(BASE))
    assert got["idle_s"] == plain["idle_s"] == pytest.approx({"step_call": 500e-6})
    assert got["busy_s"] == plain["busy_s"] and got["kernel_s"] == plain["kernel_s"]
    assert got["device_events"] == plain["device_events"] == 3


def _reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def registry(monkeypatch):
    """The port's registry, holding what a test puts in ``.held``."""
    from protein_ensemble_vae_torch.utils import profiling

    held = types.SimpleNamespace(spans=[])
    monkeypatch.setattr(profiling, "spans", lambda: list(held.spans))
    return held


TRAIN_PROGRAM = [("train.fetch", 0.0, 0.01, None, 0), ("train.step", 0.01, 0.2, None, 0),
                 ("train.forward", 0.01, 0.05, "train.step", 0),
                 ("band.fwd", 0.02, 0.021, "train.forward", 0),
                 ("train.backward", 0.05, 0.15, "train.step", 0),
                 ("band.bwd", 0.06, 0.062, None, None),
                 ("train.optimizer", 0.15, 0.17, "train.step", 0),
                 ("train.fetch", 0.2, 0.23, None, 1), ("train.step", 0.23, 0.4, None, 1),
                 ("train.forward", 0.23, 0.29, "train.step", 1),
                 ("train.backward", 0.29, 0.35, "train.step", 1),
                 ("train.optimizer", 0.35, 0.39, "train.step", 1),
                 ("train.fetch", 0.4, 0.42, None, 2)]
GEN_PROGRAM = [("refine.capture", 0.1, 0.3, "refine.cartesian", 0),
               ("refine.replay", 0.3, 1.0, "refine.cartesian", 0),
               ("refine.cartesian", 0.0, 1.1, None, 0),
               ("refine.replay", 1.1, 1.4, "refine.torsion", 0),
               ("refine.torsion", 1.1, 1.5, None, 0),
               ("refine.torsion", 2.0, 2.5, None, 1)]


@pytest.mark.parametrize("name,want", [
    ("fetch_ms.train", 1e3 * 0.06 / 2), ("forward_ms.train", 1e3 * 0.10 / 2),
    ("backward_ms.train", 1e3 * 0.16 / 2), ("optimizer_ms.train", 1e3 * 0.06 / 2),
    ("band_host_ms.train", 1e3 * 0.003 / 2)])
def test_train_span_readers(name, want, registry):
    read = _reader(name)
    rec = dict(kind="train", window_s=9.5, steps=2)
    assert read(rec) is None                        # the registry is empty: no reading
    registry.spans = TRAIN_PROGRAM
    assert read(rec) == pytest.approx(want)
    assert read(dict(rec, kind="gen")) is None
    registry.spans = [s for s in TRAIN_PROGRAM if s[0] != "train.step"]
    assert read(rec) is None


@pytest.mark.parametrize("name,want", [
    ("torsion_pct.gen", 100.0 * 0.9 / 4.0), ("replay_pct.gen", 100.0 * 1.0 / 4.0),
    ("refine_captures.gen", 1 / 2)])
def test_gen_span_readers(name, want, registry):
    read = _reader(name)
    rec = dict(kind="gen", window_s=4.0, ensembles=2, refine_s=3.0)
    assert read(rec) is None
    registry.spans = GEN_PROGRAM
    assert read(rec) == pytest.approx(want)
    assert read(dict(rec, kind="train")) is None
    assert read(dict(rec, ensembles=0, window_s=0.0)) is None


@pytest.mark.parametrize("name", TRAIN_METRICS + GEN_METRICS)
def test_span_readers_give_none_for_a_port_without_the_registry(name, monkeypatch):
    """As on the parent commit: its ``utils/profiling`` has no ``spans``."""
    from protein_ensemble_vae_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    rec = dict(kind="train" if name.endswith(".train") else "gen", window_s=4.0, ensembles=2)
    assert _reader(name)(rec) is None


def test_the_new_metrics_are_listed_for_their_cells():
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for names, cell in ((TRAIN_METRICS, "train-hd512-b16"), (GEN_METRICS, "gen-polish-default")):
        for name in names:
            assert got[name]["workloads"] == [cell], name
            assert os.path.exists(os.path.join(BENCH, "metrics", name + ".py")), name


# -- traced CPU runs of the tiny cells ---------------------------------------

def _run(root: str, cell: str) -> tuple:
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=1.0, trace=1)
    line, notes = run.execute(args, device="cpu", root=root)
    return json.loads(line), notes


@pytest.fixture
def fresh_registry():
    from protein_ensemble_vae_torch.utils import profiling

    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def test_traced_train_run_reports_the_span_metrics(tiny_root, fresh_registry):
    add_cell(tiny_root, "train-tiny", "pev-tiny", "pairs-tiny", TRAIN_LIMITS)
    out, _ = _run(tiny_root, "train-tiny")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(TRAIN_METRICS) <= set(m)
    assert m["band_host_ms.train"] == 0.0           # the CPU runs the plain version
    assert m["forward_ms.train"] + m["backward_ms.train"] + m["optimizer_ms.train"] <= \
        m["step_call_ms.train"]
    # recorded in the profiled window alone, and spans are off again after it
    assert fresh_registry.enable_spans(False) is False
    assert fresh_registry.span("train.step") is fresh_registry.span("train.fetch")
    recorded = fresh_registry.spans()
    steps = [s.request for s in recorded if s.name == "train.step"]
    assert steps and steps == list(range(steps[0], steps[0] + len(steps)))


def test_traced_gen_run_reports_the_span_metrics(tiny_root, fresh_registry):
    add_cell(tiny_root, "gen-tiny", "pev-tiny", "polish-tiny", GEN_LIMITS)
    out, _ = _run(tiny_root, "gen-tiny")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(GEN_METRICS) <= set(m)
    # eager refinement on the CPU: no graph is captured or replayed
    assert m["refine_captures.gen"] == 0.0 and m["replay_pct.gen"] == 0.0
    assert 0.0 < m["torsion_pct.gen"] < m["refine_pct.gen"]


def test_an_untraced_run_records_no_spans(tiny_root, fresh_registry):
    add_cell(tiny_root, "train-tiny", "pev-tiny", "pairs-tiny", TRAIN_LIMITS)
    args = argparse.Namespace(workload="train-tiny", seed=SEED, seconds=1.0, trace=0)
    out = json.loads(run.execute(args, device="cpu", root=tiny_root)[0])
    assert out["correct"] and fresh_registry.spans() == []


def test_a_port_without_spans_reports_none_of_them(tiny_root, monkeypatch, fresh_registry):
    """As the parent commit runs: the port has no span registry and the
    span metrics are left out of the line."""
    monkeypatch.delattr(fresh_registry, "spans")
    add_cell(tiny_root, "train-tiny", "pev-tiny", "pairs-tiny", TRAIN_LIMITS)
    out, _ = _run(tiny_root, "train-tiny")
    assert out["correct"] and "step_call_ms.train" in out["metrics"]
    assert not set(TRAIN_METRICS) & set(out["metrics"])
