"""Training: the port's ``train/training.py:run_epoch`` driving
``make_train_step``'s fp32 step over an endless stream of pair batches.

Traffic: ``proteins`` structures at the log-uniform quantiles of
``lengths``, ``conformers`` NeRF conformers each, every ordered pair of
conformers of one protein, random ESM-2 stand-in embeddings. The seed draws
folds, embeddings, sequences, weights and dropout, never the lengths or
the order of pairs. Batches come from the program's ``data/collate.py:
make_epoch_batches`` (``batch_size`` pairs, remainders dropped, shuffled
by ``PAIR_ORDER_SEED``), run per length bucket and interleaved in a
pattern fixed by the bucket counts, so every seed runs the same steps.

Set-up builds one step object (model, ``TrainState``, step) and drives it
through ``run_epoch`` with one batch of every bucket, largest first. The
first ``checked_steps`` of them are what ``correct`` compares: each step's
loss, the first step's gradient as the optimizer took it (its first moment
after one step, over 1 - b1) and the parameters' change after the checked
steps, against the plain reference run from the same weights, pairs and
dropout seeds (the reference pads its own batches from the pairs the
program was handed, so a fault in collation shows). The window then drives the same object through
``run_epoch`` until ``--seconds`` have passed.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from port_bench import counts
from port_bench.data import log_uniform_lengths, make_structures
from port_bench.harness import Check
from port_bench.reference.train import fold_seed

# the order of pairs and batches is the same for every seed, so the valid
# residues of every step, and the work of the window, are too
PAIR_ORDER_SEED = 19
KERNEL_FWD = r"egnn\w*fwd"
KERNEL_BWD = r"egnn\w*(bwd|wgrad)"


class PairSet:
    """Ordered conformer pairs of the structures, with the dataset surface
    ``make_epoch_batches`` reads (``__len__``, ``__getitem__`` -> (input,
    target) dicts, ``pair_length``, ``use_seqemb``, ``seqemb_dim``).
    ``log`` lists every pair handed out, in order, shared with subsets: the
    batches the program collates are its consecutive runs of batch size."""

    use_seqemb = True

    def __init__(self, structures: list, pairs: list, seqemb_dim: int, log: list = None):
        self.structures, self.pairs, self.seqemb_dim = structures, pairs, seqemb_dim
        self.log = [] if log is None else log

    def __len__(self) -> int:
        return len(self.pairs)

    def _item(self, s: dict, k: int) -> dict:
        return dict(s["conformers"][k], seq_emb=s["seq_emb"], seq_labels=s["seq_labels"])

    def __getitem__(self, idx: int):
        p, i, j = self.pairs[idx]
        self.log.append((p, i, j))
        s = self.structures[p]
        return self._item(s, i), self._item(s, j)

    def pair_length(self, idx: int) -> int:
        return len(self.structures[self.pairs[idx][0]]["seq_labels"])

    def subset(self, ids) -> "PairSet":
        return PairSet(self.structures, [self.pairs[i] for i in ids], self.seqemb_dim, self.log)


def pair_set(traffic: dict, seqemb_dim: int, rng: np.random.Generator, device) -> PairSet:
    lengths = log_uniform_lengths(*traffic["lengths"], traffic["proteins"])
    K = traffic["conformers"]
    structures = make_structures(lengths, K, rng, seqemb_dim, traffic["fold_tries"], device)
    pairs = [(p, i, j) for p in range(len(lengths)) for i in range(K) for j in range(K) if i != j]
    return PairSet(structures, pairs, seqemb_dim)


class Stream:
    """The traffic's batches. ``batches(epoch)`` is one epoch in the fixed
    pattern; ``warmup()`` is one batch of every bucket, largest first;
    ``feed(source, deadline)`` hands batches out of ``source`` until the
    clock passes ``deadline``, timing each ``next()`` and counting the
    valid target residues it handed out."""

    def __init__(self, ds: PairSet, traffic: dict, spans):
        from protein_ensemble_vae_torch.data.collate import bucket_for

        self.bs, self.buckets = traffic["batch_size"], tuple(traffic["buckets"])
        self.spans = spans
        ids: dict = {}
        for i in range(len(ds)):
            ids.setdefault(bucket_for(ds.pair_length(i), self.buckets), []).append(i)
        self.sub = {b: ds.subset(v) for b, v in ids.items()}
        per = {b: len(v) // self.bs for b, v in ids.items() if len(v) >= self.bs}
        slots = [((k + 0.5) / n, -b, b) for b, n in per.items() for k in range(n)]
        self.pattern = [b for _, _, b in sorted(slots)]
        self.residues, self.shapes = 0, []

    def _bucket(self, b: int, *tags: int):
        from protein_ensemble_vae_torch.data.collate import make_epoch_batches

        return make_epoch_batches(self.sub[b], self.bs, self.buckets, True,
                                  fold_seed(PAIR_ORDER_SEED, *tags, b), drop_remainder=True)

    def batches(self, epoch: int):
        gens = {b: self._bucket(b, 0, epoch) for b in set(self.pattern)}
        for b in self.pattern:
            yield next(gens[b])

    def warmup(self):
        for b in sorted(set(self.pattern), reverse=True):
            yield next(iter(self._bucket(b, 1)))

    def endless(self):
        for epoch in itertools.count():
            yield from self.batches(epoch)

    def feed(self, source, deadline: float):
        it = iter(source)
        while time.perf_counter() < deadline:
            with self.spans.span("collate"):
                batch = next(it, None)
            if batch is None:
                return
            mask = batch.tgt.mask
            self.residues += int(mask.sum())
            self.shapes.append([int(n) for n in mask.sum(1)] + [mask.shape[1]])
            yield batch


class Steps:
    """The step function handed to ``run_epoch``: the program's step, timed
    on the host; the first ``checked`` steps of the state also leave what
    ``correct`` compares (dropout seed, loss, first moment after the first
    step, parameters after the last checked one)."""

    def __init__(self, step, checked: int, spans):
        self.step, self.checked, self.spans = step, checked, spans
        self.record: list = []
        self.mu1 = self.flat_after = None

    def __call__(self, state, batch, rng, klw_g, klw_l, lr):
        k = state.step
        with self.spans.span("step_call"):
            state, metrics = self.step(state, batch, rng, klw_g, klw_l, lr)
        if k < self.checked:
            self.record.append(dict(seed=fold_seed(rng, k), loss=metrics["loss"].detach().clone()))
            if k == 0:
                self.mu1 = state.mu.clone()
            if k == self.checked - 1:
                self.flat_after = state.flat.clone()
        return state, metrics


def leaf_norms(vecs: dict) -> dict:
    """{name: L2 norm} of {name: tensor}, read in one copy."""
    names = list(vecs)
    norms = torch.stack([torch.linalg.vector_norm(vecs[n].double()) for n in names]).cpu()
    return dict(zip(names, norms.tolist()))


def reference_run(cfg: dict, traffic: dict, w0: dict, structures: list, record: list, device,
                  tf32: bool = False, half_batch: bool = False) -> dict:
    """The plain reference through the checked steps from weights ``w0``
    on the recorded pairs (padded by ``reference.train.pad_batch``) and
    dropout seeds: each step's loss, the first step's clipped gradient and
    the parameters' change, each as norms by leaf. ``tf32`` runs its
    products in TF32 (the control); ``half_batch`` keeps the first half of
    each batch's rows (a fault)."""
    from port_bench.reference.model import HierCVAE
    from port_bench.reference.train import AdamState, apply_update, loss_and_grads, pad_batch

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    model = HierCVAE(cfg).to(device)
    model.load_state_dict(w0)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    state = AdamState(params)
    losses, g1 = [], None
    for k, rec in enumerate(record):
        batch = pad_batch(structures, rec["pairs"], traffic["buckets"], device)
        if half_batch:
            h = batch["tgt"]["mask"].shape[0] // 2
            batch = {s: {f: t[:h] for f, t in d.items()} for s, d in batch.items()}
        loss, grads = loss_and_grads(model, batch, rec["seed"], None, traffic["klw_global"],
                                     traffic["klw_local"], _weights(traffic))
        grads = apply_update(params, grads, state, traffic["lr"], traffic["grad_clip"])
        losses.append(loss)
        if k == 0:
            g1 = leaf_norms(dict(zip(names, grads)))
    change = leaf_norms({n: p.detach() - w0[n] for n, p in zip(names, params)})
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return dict(losses=losses, grad=g1, change=change)


def _weights(traffic: dict):
    from types import SimpleNamespace

    return SimpleNamespace(**traffic["loss_weights"])


def worst_leaf_gap(got: dict, want: dict, grads: dict = None) -> float:
    """The largest gap of norms over the leaves, | |got| - |want| | over the
    larger of |want| and the median leaf's |want|. With ``grads`` (the
    reference's first gradient norms), leaves whose gradient is under a
    thousandth of the median leaf's are left out: under Adam they move by
    round-off alone."""
    med_g = float(np.median(list(grads.values()))) if grads else 0.0
    med = float(np.median([want[n] for n in want]))
    worst = 0.0
    for n, w in want.items():
        if grads and grads[n] < 1e-3 * med_g:
            continue
        gap = abs(got[n] - w) / max(w, med)
        if not gap <= worst:     # a NaN gap is the worst
            worst = gap
    return worst


def judge(prog: dict, ref: dict) -> dict:
    """The three numbers ``correct`` compares: the loss's largest relative
    gap over the checked steps, and the worst leaf's gap of the first
    gradient's and of the change's norms."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad = worst_leaf_gap(prog["grad"], ref["grad"])
    change = worst_leaf_gap(prog["change"], ref["change"], ref["grad"])
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change)


def setup_data(cell, seed: int, device):
    """The cell's pair set and weights from the seed."""
    import dataclasses

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models.vae import HierCVAE

    from port_bench.weights import make_weights

    mcfg = ModelConfig.from_dict(cell.config["model"])
    rng = np.random.default_rng([seed, 1])
    ds = pair_set(cell.traffic, mcfg.seqemb_dim, rng, device)
    with torch.device(device):
        model = HierCVAE(mcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    w0 = make_weights(shapes, fold_seed(seed, 2), device)
    model.load_state_dict(w0)
    return ds, model, w0, dataclasses.asdict(mcfg)


def run(cell, args, device, spans, profiler_ctx) -> dict:
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32
    from protein_ensemble_vae_torch.train.training import (TrainState, make_train_step,
                                                           run_epoch)
    from protein_ensemble_vae_torch.utils.compile_cache import enable_compilation_cache

    from port_bench.harness import reduce_trace

    enable_compilation_cache()
    set_full_fp32()
    tr = cell.traffic
    phases = [("start", time.perf_counter())]
    ds, model, w0, cfg = setup_data(cell, args.seed, device)
    phases.append(("data and weights", time.perf_counter()))
    stream = Stream(ds, tr, spans)
    state = TrainState.create(model)
    steps = Steps(make_train_step(model, LossWeights(**tr["loss_weights"]), train=True,
                                  grad_clip=tr["grad_clip"]), tr["checked_steps"], spans)
    kl = (tr["klw_global"], tr["klw_local"], tr["lr"])
    seqemb = cfg["seqemb_dim"]
    run_epoch(state, steps, stream.feed(stream.warmup(), float("inf")),
              fold_seed(args.seed, 3), *kl, seqemb)
    _sync(device)
    phases.append(("checked and warm-up steps", time.perf_counter()))
    stream.residues, stream.shapes = 0, []
    spans.items.clear()
    with profiler_ctx as prof:
        with spans.span("window"):
            t0 = time.perf_counter()
            _, stats = run_epoch(state, steps, stream.feed(stream.endless(), t0 + args.seconds),
                                 fold_seed(args.seed, 4), *kl, seqemb)
            _sync(device)
            t1 = time.perf_counter()
    trace = reduce_trace(prof) if prof is not None else None
    t_stop = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    names = state.names
    prog = dict(losses=[float(r["loss"]) for r in steps.record],
                grad=leaf_norms(dict(zip(names, state.views(steps.mu1 / (1 - 0.9))))),
                change=leaf_norms({n: v - w0[n] for n, v in
                                   zip(names, state.views(steps.flat_after))}))
    bs = tr["batch_size"]
    record = [dict(r, pairs=ds.log[k * bs:(k + 1) * bs]) for k, r in enumerate(steps.record)]
    del state, steps, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_run(cfg, tr, w0, ds.structures, record, device)
    gaps = judge(prog, ref)
    notes = [f"set-up: {a} {b - a0:.3f} s" for (_, a0), (a, b) in zip(phases, phases[1:])]
    notes.append(f"profiler stop and trace reduction: {t_stop - t1:.3f} s")
    notes.append(f"reference: {time.perf_counter() - t_ref:.3f} s")
    checks = [Check(k, v, cell.limits[k]) for k, v in gaps.items()]

    hd, W, layers = cfg["decoder_hidden"], cfg["max_neighbors"], cfg["decoder_layers"]
    fwd_s = bwd_s = flops = 0.0
    for shape in stream.shapes:
        lens, L = shape[:-1], shape[-1]
        edges = sum(counts.band_edges(n, W) for n in lens)
        fwd_s += layers * counts.least_seconds(*counts.band_fwd_launch(len(lens), L, hd, edges))
        bwd_s += layers * counts.least_seconds(*counts.band_bwd_launch(len(lens), L, hd, edges))
        flops += counts.train_step_flops(cfg, lens)
    records = dict(kind="train", window_s=t1 - t0, steps=len(stream.shapes),
                   residues=stream.residues, flops=flops, band_fwd_least_s=fwd_s,
                   band_bwd_least_s=bwd_s, kernel_fwd=KERNEL_FWD, kernel_bwd=KERNEL_BWD,
                   step_call_s=spans.seconds("step_call"), collate_s=spans.seconds("collate"),
                   trace=trace)
    return dict(t0=t0, window_s=t1 - t0, e2e={"train_residues_per_s": stream.residues / (t1 - t0)},
                attempted=len(stream.shapes),
                failed=int(round(stats["nonfinite_frac"] * len(stream.shapes))),
                checks=checks, records=records, memory_peak=peak, notes=notes)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
