"""The port's spans (``protein_ensemble_vae_torch.utils.profiling.span``):
off they are one shared context that records nothing; on they record
(name, start, end, parent, request) on ``time.perf_counter`` (replaced by
an injected clock here, so no assertion rests on wall time) and put a
``pev::<name>`` annotation on the profiler's timeline; any
``torch.profiler`` session turns them on for its block. The train loop and
generation open theirs where the work happens: ``run_epoch`` and the step
(``train.fetch``, ``train.step``, ``train.forward``, ``train.backward``,
``train.optimizer``) and each refinement stage (``refine.cartesian``,
``refine.torsion``), with the step or structure index as the request.
The CUDA spans (``band.fwd`` / ``band.bwd``, ``refine.capture`` /
``refine.replay``) are tested in ``tests/test_torch_gpu.py``."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.utils import profiling as TP  # noqa: E402


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


@pytest.fixture
def spans_on():
    was = TP.enable_spans(True)
    TP.reset_spans()
    try:
        yield
    finally:
        TP.enable_spans(was)
        TP.reset_spans()


def test_spans_off_are_one_shared_context_that_records_nothing():
    was = TP.enable_spans(False)
    TP.reset_spans()
    try:
        a, b = TP.span("train.step", 3), TP.span("band.fwd")
        assert a is b
        with a, b:
            pass
        assert TP.spans() == []
    finally:
        TP.enable_spans(was)


def test_enable_spans_returns_the_previous_state():
    was = TP.enable_spans(True)
    try:
        assert TP.enable_spans(False) is True
        assert TP.enable_spans(False) is False
    finally:
        TP.enable_spans(was)


def test_nested_spans_carry_parent_request_and_seconds(clock, spans_on):
    with TP.span("outer", 7):
        clock.t += 0.5
        with TP.span("inner"):
            clock.t += 0.25
        with TP.span("other", 9):
            clock.t += 0.125
    with TP.span("alone"):
        clock.t += 1.0
    got = {s.name: s for s in TP.spans()}
    assert [s.name for s in TP.spans()] == ["inner", "other", "outer", "alone"]
    assert got["outer"] == TP.Span("outer", 100.0, 100.875, None, 7)
    assert got["inner"] == TP.Span("inner", 100.5, 100.75, "outer", 7)   # request inherited
    assert got["other"] == TP.Span("other", 100.75, 100.875, "outer", 9)
    assert got["alone"] == TP.Span("alone", 100.875, 101.875, None, None)
    TP.reset_spans()
    assert TP.spans() == []


def test_a_span_that_raises_is_recorded_and_closed(clock, spans_on):
    with pytest.raises(ValueError):
        with TP.span("outer", 1):
            clock.t += 0.5
            raise ValueError("boom")
    with TP.span("next"):
        pass
    assert [(s.name, s.parent) for s in TP.spans()] == [("outer", None), ("next", None)]
    assert TP.spans()[0].end - TP.spans()[0].start == 0.5


def test_spans_on_another_thread_have_no_parent(spans_on):
    def work():
        with TP.span("band.bwd"):
            pass

    with TP.span("train.backward", 4):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = {s.name: s for s in TP.spans()}
    assert got["band.bwd"].parent is None and got["band.bwd"].request is None
    assert got["train.backward"].request == 4


def test_spans_are_profiler_annotations(spans_on):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TP.span("train.step", 0):
            with TP.span("train.forward"):
                x = torch.ones(32, 32)
                (x @ x).sum()
    names = {e.name for e in prof.events()}
    assert {"pev::train.step", "pev::train.forward"} <= names
    fwd = next(e for e in prof.events() if e.name == "pev::train.forward")
    step = next(e for e in prof.events() if e.name == "pev::train.step")
    assert step.time_range.start <= fwd.time_range.start
    assert fwd.time_range.end <= step.time_range.end


def test_a_profiler_session_turns_spans_on_for_its_block():
    from torch.profiler import ProfilerActivity, profile

    was = TP.enable_spans(False)
    TP.reset_spans()
    try:
        with TP.span("train.fetch"):                    # before the session: off
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with TP.span("train.step", 7):
                with TP.span("train.forward"):
                    (torch.ones(8) * 2).sum()
        with TP.span("train.fetch"):                    # after it: off again
            pass
        assert [(s.name, s.parent, s.request) for s in TP.spans()] == [
            ("train.forward", "train.step", 7), ("train.step", None, 7)]
        assert {"pev::train.step", "pev::train.forward"} <= {e.name for e in prof.events()}
        assert TP.enable_spans(False) is False
    finally:
        TP.enable_spans(was)
        TP.reset_spans()


def test_trace_turns_spans_on_for_its_block(tmp_path):
    was = TP.enable_spans(False)
    TP.reset_spans()
    try:
        with TP.trace(str(tmp_path / "tr")):
            with TP.span("refine.replay", 2):
                (torch.ones(8) * 2).sum()
        assert [s.name for s in TP.spans()] == ["refine.replay"]
        assert TP.enable_spans(False) is False          # off again after the block
    finally:
        TP.enable_spans(was)
        TP.reset_spans()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pev::refine.replay" for e in events)


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------

TRAIN_SPANS = ("train.fetch", "train.step", "train.forward", "train.backward",
               "train.optimizer")


def _pair_batches(n, B, L, seqemb_dim):
    from protein_ensemble_vae_torch.data.collate import ConformerBatch, PairBatch

    out = []
    for k in range(n):
        r = np.random.default_rng(k)
        conf = ConformerBatch(
            n=r.normal(0, 3, (B, L, 3)).astype(np.float32),
            ca=r.normal(0, 3, (B, L, 3)).astype(np.float32),
            c=r.normal(0, 3, (B, L, 3)).astype(np.float32),
            mask=np.ones((B, L), np.float32),
            seq_emb=r.normal(0, 1, (B, L, seqemb_dim)).astype(np.float32),
            dihedrals=r.normal(0, 1, (B, L, 6)).astype(np.float32),
            seq_labels=np.zeros((B, L), np.int32))
        out.append(PairBatch(inp=conf, tgt=conf))
    return out


def _tiny_train():
    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.parallel.dryrun import DRYRUN_MODEL
    from protein_ensemble_vae_torch.train.training import TrainState, make_train_step

    torch.manual_seed(0)
    cfg = ModelConfig(**DRYRUN_MODEL)
    model = HierCVAE(cfg)
    state = TrainState.create(model)
    return cfg, state, make_train_step(model, LossWeights(), train=True)


def test_run_epoch_records_each_train_span_once_per_step(spans_on):
    from protein_ensemble_vae_torch.train.training import run_epoch

    cfg, state, step = _tiny_train()
    state.step = 5
    state, stats = run_epoch(state, step, _pair_batches(2, 2, 12, cfg.seqemb_dim), 0,
                             1.0, 0.5, 1e-4, cfg.seqemb_dim)
    assert np.isfinite(stats["loss"]) and state.step == 7
    got = TP.spans()
    for name in TRAIN_SPANS:
        # one more fetch than steps: the one that finds the stream empty
        want = [5, 6, 7] if name == "train.fetch" else [5, 6]
        assert [s.request for s in got if s.name == name] == want, name
    parents = {s.name: s.parent for s in got}
    assert parents["train.fetch"] is None and parents["train.step"] is None
    assert parents["train.forward"] == parents["train.backward"] == "train.step"
    assert parents["train.optimizer"] == "train.step"
    for s in got:
        assert s.end >= s.start
    steps = [s for s in got if s.name == "train.step"]
    for s in got:
        if s.parent == "train.step":
            assert any(p.start <= s.start and s.end <= p.end for p in steps), s


def test_run_epoch_spans_off_record_nothing_and_train_alike():
    """The same two steps with spans on and off reach the same parameters."""
    from protein_ensemble_vae_torch.train.training import run_epoch

    flats = []
    for on in (False, True):
        cfg, state, step = _tiny_train()
        was = TP.enable_spans(on)
        TP.reset_spans()
        try:
            run_epoch(state, step, _pair_batches(2, 2, 12, cfg.seqemb_dim), 0,
                      1.0, 0.5, 1e-4, cfg.seqemb_dim)
            recorded = TP.spans()
        finally:
            TP.enable_spans(was)
            TP.reset_spans()
        assert bool(recorded) == on
        flats.append(state.flat.clone())
    assert torch.equal(flats[0], flats[1])


def test_eval_step_records_its_forward(spans_on):
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.parallel.dryrun import example_batch
    from protein_ensemble_vae_torch.train.training import make_train_step

    cfg, state, _ = _tiny_train()
    step = make_train_step(state.model, LossWeights(), train=False)
    batch = {s: {k: torch.from_numpy(v) for k, v in d.items()}
             for s, d in example_batch(cfg.seqemb_dim, 2, 12).items()}
    step(state, batch, 0, *[torch.tensor(v) for v in (1.0, 0.5, 1e-4)])
    assert [(s.name, s.request) for s in TP.spans()] == [("train.forward", 0)]


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _view(n_structures, L, seqemb_dim):
    import types

    from protein_ensemble_vae_torch.data.dataset import Conformer, SingleConformerView
    from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble

    confs, proteins = [], {}
    for i in range(n_structures):
        n, ca, c = (a[0] for a in nerf_ensemble(L, 1, seed=i))
        pid = f"p{i}"
        confs.append(Conformer(n=n, ca=ca, c=c, mask=np.ones(L, np.float32),
                               seq_emb=np.random.default_rng(i).normal(
                                   0, 1, (L, seqemb_dim)).astype(np.float32),
                               dihedrals=np.zeros((L, 6), np.float32), sequence="A" * L,
                               protein_id=pid, h5_path=""))
        proteins[pid] = [i]
    return SingleConformerView(types.SimpleNamespace(conformers=confs, proteins=proteins))


def _staged(clock, seconds):
    """A refiner that takes ``seconds`` on the injected clock."""
    def refine(n, ca, c, mask, **kw):
        clock.t += seconds
        return n, ca, c
    return refine


@pytest.mark.parametrize("on", [False, True])
def test_generate_polish_records_both_stage_spans_per_structure(clock, monkeypatch,
                                                                tmp_path, on):
    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.infer import generate as G
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.parallel.dryrun import DRYRUN_MODEL

    monkeypatch.setattr(G, "refine_backbone", _staged(clock, 0.5))
    monkeypatch.setattr(G, "refine_torsions", _staged(clock, 0.25))
    torch.manual_seed(0)
    cfg = ModelConfig(**DRYRUN_MODEL)
    model = HierCVAE(cfg)
    was = TP.enable_spans(on)
    TP.reset_spans()
    try:
        out = G.generate_ensembles(model, _view(2, 20, cfg.seqemb_dim), str(tmp_path),
                                   num_samples=2, buckets=(32,), refine_steps=3,
                                   refine_mode="polish", verbose=False)
        got = TP.spans()
    finally:
        TP.enable_spans(was)
        TP.reset_spans()
    for r in out["results"]:
        assert r["refine_seconds"] == {"cartesian": 0.5, "torsion": 0.25}
    if not on:
        assert got == []
        return
    assert [(s.name, s.request) for s in got] == [
        ("refine.cartesian", 0), ("refine.torsion", 0),
        ("refine.cartesian", 1), ("refine.torsion", 1)]
    assert [s.end - s.start for s in got] == [0.5, 0.25, 0.5, 0.25]
    assert all(s.parent is None for s in got)


def test_eager_refinement_records_no_capture_or_replay(spans_on):
    """On the CPU the Adam loop runs eagerly: no graph is captured or
    replayed, so neither span appears."""
    from protein_ensemble_vae_torch.infer.refine import adam_descent

    x0 = torch.ones(4)
    x = adam_descent(lambda x, c: ((x - c["t"]) ** 2).sum(), x0, {"t": torch.zeros(4)},
                     0.1, steps=3, lr_decay=False, key=("quadratic",))
    assert float(x.sum()) < 4.0
    assert TP.spans() == []


def test_band_kernels_plain_version_records_no_launch_span(spans_on):
    """``band.fwd`` / ``band.bwd`` time the host work of a CUDA launch; the
    plain version that CPU tensors run records neither."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_fwd

    B, L, Hd, W = 1, 6, 4, 2
    g = torch.Generator().manual_seed(0)
    a, bs = torch.randn(B, L, Hd, generator=g), torch.randn(B, L, Hd, generator=g)
    x, cmask = torch.randn(B, L, 3, generator=g), torch.ones(B, L)
    w = [torch.randn(*s, generator=g) * 0.1
         for s in ((Hd,), (Hd, Hd), (Hd,), (Hd, Hd), (Hd,), (Hd,), (1,))]
    agg, delta = egnn_band_fwd(a, bs, x, cmask, *w, W)
    assert agg.shape == (B, L, Hd) and delta.shape == (B, L, 3)
    assert TP.spans() == []
