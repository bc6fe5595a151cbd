"""Timing and profiling harnesses of the port
(``protein_ensemble_vae_torch.utils.profiling``) against the JAX package's
``utils/profiling.py``: ``time_fn``, ``scan_step_time`` and ``step_timer``
on an injected clock (``time.perf_counter`` replaced, so no assertion rests
on wall time), each beside the JAX function on the same clock; ``trace``
writes a Chrome trace; ``enable_debug_mode`` raises at the op that first
makes a NaN, forward or backward, and in a kernel's outputs, and stays
silent on a normal train step and on allocations."""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import check_outputs  # noqa: E402
from protein_ensemble_vae_torch.utils import profiling as TP  # noqa: E402
from protein_ensemble_vae_tpu.utils import profiling as JP  # noqa: E402


class Clock:
    """A perf_counter that moves only when the code under test says."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def test_time_fn_on_an_injected_clock(clock):
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        clock.t += 0.25 * scale
        return torch.full((2,), float(x))

    got = TP.time_fn(fn, 3, warmup=2, iters=4, scale=2.0)
    assert len(calls) == 6
    assert got == {"mean_s": 0.5, "iters": 4, "per_sec": 2.0}

    def jfn(x, scale=1.0):
        clock.t += 0.25 * scale
        return np.full((2,), float(x))

    assert JP.time_fn(jfn, 3, warmup=2, iters=4, scale=2.0) == got


def test_scan_step_time_differences_two_run_lengths(clock):
    def make_run(n):
        def run():
            clock.t += 0.2 + 0.01 * n           # fixed overhead + n steps
            return torch.tensor(float(n))
        return run

    best, detail = TP.scan_step_time(make_run, n1=2, n2=10, repeats=3,
                                     return_detail=True)
    jbest, jdetail = JP.scan_step_time(make_run, n1=2, n2=10, repeats=3,
                                       return_detail=True)
    assert best == pytest.approx(0.01, rel=1e-9)
    assert best == jbest and detail == jdetail
    assert detail["method"] == "scan-diff" and len(detail["repeats"]) == 3
    assert set(detail["repeats"][0]) == {"t_n1_s", "t_n2_s", "per_step_ms"}
    assert TP.scan_step_time(make_run, n1=2, n2=10, repeats=2) == pytest.approx(0.01)


def test_step_timer(clock):
    with TP.step_timer() as t:
        clock.t += 0.0125
    with JP.step_timer() as j:
        clock.t += 0.0125
    assert t.ms == j.ms == pytest.approx(12.5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "tr")) as logdir:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert logdir == str(tmp_path / "tr")
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.fixture
def debug_mode():
    TP.enable_debug_mode()
    try:
        yield
    finally:
        TP.disable_debug_mode()


def test_debug_mode_raises_on_a_forward_nan(debug_mode):
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(x)
    with pytest.raises(FloatingPointError, match="aten.lift_fresh"):
        torch.tensor([np.nan])


def test_debug_mode_checks_the_kernels_outputs():
    """What a kernel wrote into ``torch.empty`` memory is checked when its
    autograd function has it (``ops.kernels.check_outputs``)."""
    good, bad = torch.zeros(2), torch.tensor([1.0, np.nan])
    check_outputs("egnn_band_fwd", good, bad)         # off: nothing checked
    TP.enable_debug_mode()
    try:
        check_outputs("egnn_band_fwd", good)
        with pytest.raises(FloatingPointError, match="kernel egnn_band_fwd"):
            check_outputs("egnn_band_fwd", good, bad)
    finally:
        TP.disable_debug_mode()


def test_debug_mode_raises_on_a_backward_nan(debug_mode):
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()      # finite forward, 0 * inf backward
    assert float(y) == 0.0
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan"):
        y.backward()


def test_debug_mode_silent_on_a_train_step_and_allocations():
    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.parallel.dryrun import DRYRUN_MODEL, example_batch
    from protein_ensemble_vae_torch.train.training import TrainState, make_train_step

    torch.manual_seed(0)
    model = HierCVAE(ModelConfig(**DRYRUN_MODEL))
    state = TrainState.create(model)
    step = make_train_step(model, LossWeights(), train=True)
    batch = {s: {k: torch.from_numpy(v) for k, v in d.items()}
             for s, d in example_batch(DRYRUN_MODEL["seqemb_dim"], 2, 16).items()}
    consts = [torch.tensor(v) for v in (1.0, 0.5, 1e-4)]
    for n in (64, 256, 1024):               # freed NaN memory for empty() to take
        del_me = torch.full((n,), float("nan"))
        del del_me
    TP.enable_debug_mode()
    try:
        TP.enable_debug_mode()              # a second call changes nothing
        for n in (64, 256, 1024):
            a = torch.empty(n)
            b = torch.empty_like(a)
            c = a.new_empty((n,))
            for t in (a, b, c):
                t.fill_(1.0)
        _, metrics = step(state, batch, 0, *consts)
    finally:
        TP.disable_debug_mode()
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert not torch.is_anomaly_enabled()
    torch.log(torch.tensor([-1.0]))          # off again: NaN passes


def test_debug_mode_off_does_nothing():
    TP.enable_debug_mode(nans=False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
