"""Generation: the port's ``infer/generate.py:generate_ensembles``, one
call per structure, polished ensembles.

Traffic: ``structures`` NeRF folds at the log-uniform quantiles of
``lengths``, random ESM-2 stand-in embeddings and sequences; each call
decodes ``num_samples`` posterior latents at ``temperature`` and refines
them in ``refine_mode`` (the flagship battery's flags), then gates them and
writes the PDB files under ``TMPDIR``. The structures are cycled in a
pattern of length buckets fixed by the bucket counts, a bucket's
structures by length, until ``--seconds`` have passed; each call has its
own seed. Set-up makes one call per bucket, uncounted, which captures
the refiners' CUDA graphs. A traced run (``--trace 1``) traces the first
``traced_calls`` calls of the window and ends there.

``correct``: for a sample of the calls finished in the window, drawn from
the seed with the longest structure always in it, against the plain
reference run from the same inputs, weights and call seed
(``reference/``): the decoded ensemble that the refinement starts from
and the reconstruction written to its PDB file, by their largest
coordinate gap; the Cartesian stage's output against the reference's
Cartesian stage run from the reference's own decode; the torsion stage's
output, and the ensemble written to its PDB file (against the reference's
coordinates printed as the file prints them), against the reference's
torsion stage run from the port's Cartesian output (the reference follows
the port from there: the Cartesian stage is chaotic in rounding, so its
two outputs differ by more than the torsion stage could be held to). The
refined coordinates are compared by the median over the samples (the
written models) of each one's largest gap: a few samples of the chaotic
Cartesian stage land far apart on sound runs, a lower precision moves
most of them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import types

import numpy as np
import torch

from port_bench.data import log_uniform_lengths, make_structures
from port_bench.harness import Check
from port_bench.reference.train import fold_seed


def _view(s: dict, pid: str):
    """A one-structure ``SingleConformerView`` of the port."""
    from protein_ensemble_vae_torch.data.dataset import Conformer, SingleConformerView

    c = s["conformers"][0]
    conf = Conformer(n=c["n"], ca=c["ca"], c=c["c"], mask=c["mask"], seq_emb=s["seq_emb"],
                     dihedrals=c["dihedrals"], sequence=s["sequence"], protein_id=pid,
                     h5_path="")
    return SingleConformerView(types.SimpleNamespace(conformers=[conf], proteins={pid: [0]}))


def read_backbone(path: str) -> np.ndarray:
    """[models, residues, 3 (N, CA, C), 3] from a PDB file."""
    models, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("ATOM  ") and line[12:16].strip() in ("N", "CA", "C"):
                cur.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
            elif line.startswith("ENDMDL"):
                models.append(cur)
                cur = []
    if cur:
        models.append(cur)
    return np.asarray(models, np.float64).reshape(len(models), -1, 3, 3)


def order(lengths, buckets) -> list:
    """Structure indices, one cycle: buckets interleaved in a pattern fixed
    by their counts, a bucket's structures by length. The same for every
    seed, so every stretch of the window holds the same sizes."""
    from protein_ensemble_vae_torch.data.collate import bucket_for

    by: dict = {}
    for i, L in enumerate(lengths):
        by.setdefault(bucket_for(L, buckets), []).append(i)
    slots = sorted(((k + 0.5) / len(v), -b, b) for b, v in by.items() for k in range(len(v)))
    nxt = {b: iter(v) for b, v in by.items()}
    return [int(next(nxt[b])) for _, _, b in slots]


def _kwargs(tr: dict) -> dict:
    return dict(num_samples=tr["num_samples"], temperature=tr["temperature"],
                latent_source="posterior", refine_steps=tr["refine_steps"],
                refine_lr=tr["refine_lr"], refine_anchor=tr["refine_anchor"],
                refine_w_rama=tr["refine_w_rama"], refine_kwargs=dict(tr["refine_kwargs"]),
                refine_mode=tr["refine_mode"], buckets=tuple(tr["buckets"]), verbose=False)


def padded_inputs(s: dict, L_pad: int, device) -> tuple:
    """(seq_emb, n, ca, c, dihedrals) and the mask of structure ``s``,
    padded to ``L_pad``, batch 1, on ``device``."""
    c = s["conformers"][0]
    L = len(s["seq_labels"])

    def pad(a):
        out = np.zeros((1, L_pad) + a.shape[1:], np.float32)
        out[0, :L] = a
        return torch.from_numpy(out).to(device)

    return ([pad(a) for a in (s["seq_emb"], c["n"], c["ca"], c["c"], c["dihedrals"])],
            pad(c["mask"]))


def sample_gaps(got: torch.Tensor, want: torch.Tensor, L: int):
    """Each sample's largest coordinate gap over the first ``L`` residues of
    stacked N/CA/C [3, S, L_pad, 3]; None where the shapes differ."""
    if got.shape != want.shape:
        return None
    return (got[:, :, :L] - want[:, :, :L]).abs().amax(dim=(0, 2, 3)).cpu().numpy()


def median_gap(got: torch.Tensor, want: torch.Tensor, L: int) -> float:
    g = sample_gaps(got, want, L)
    return float("inf") if g is None else float(np.median(g))


def pdb_digits(a: np.ndarray) -> np.ndarray:
    """``a`` as a PDB file holds it: each coordinate printed to 3 decimals."""
    return np.array([float(f"{v:8.3f}") for v in a.ravel().tolist()]).reshape(a.shape)


def model_gaps(models: np.ndarray, want: torch.Tensor) -> np.ndarray:
    """Each written model's [L, 3 (N, CA, C), 3] largest coordinate gap to
    the nearest of the samples ``want`` [3, S, L_pad, 3] as a PDB file
    would hold them (the gate keeps some of the samples, in order)."""
    w = pdb_digits(want[:, :, :models.shape[1]].permute(1, 2, 0, 3).cpu().numpy())
    return np.abs(models[:, None] - w[None]).max(axis=(2, 3, 4)).min(axis=1)


def reference_chain(model, s: dict, call: dict, tr: dict, device) -> dict:
    """The reference's reconstruction, decoded ensemble and Cartesian
    stage output for ``call`` (the structure padded to its bucket, the
    call's seed), in the precision the TF32 flags give."""
    from port_bench.reference.generate import POLISH_CARTESIAN, decode
    from port_bench.reference.refine import cartesian

    inputs, mask = padded_inputs(s, call["bucket"], device)
    rec, dec = decode(model, inputs, mask, num_samples=tr["num_samples"], seed=call["seed"],
                      temperature=tr["temperature"])
    return dict(rec=rec, dec=dec, mask=mask.expand(dec.shape[1], mask.shape[1]),
                cart=cartesian(dec, mask.expand(dec.shape[1], mask.shape[1]), POLISH_CARTESIAN))


def judge(got: dict, ref: dict, fin: torch.Tensor, L: int) -> dict:
    """The numbers ``correct`` compares for one call. ``got``: the
    program's ``start``, ``cartesian`` and ``final`` stage tensors [3, S,
    L_pad, 3] and what its PDB files hold, ``rec`` [L, 3, 3] and ``models``
    [M, L, 3, 3]; ``ref``: ``reference_chain``'s; ``fin``: the reference's
    torsion stage from ``got["cartesian"]``."""
    start = got["start"]
    return dict(
        decode_gap_A=(float((start - ref["dec"]).abs().max()) if start.shape == ref["dec"].shape
                      else float("inf")),
        reconstruction_gap_A=float(np.abs(got["rec"] - ref["rec"][:L].cpu().numpy()).max()),
        cartesian_gap_A=median_gap(got["cartesian"], ref["cart"], L),
        torsion_gap_A=median_gap(got["final"], fin, L),
        ensemble_gap_A=float(np.median(model_gaps(got["models"], fin))))


def reference_gaps(cfg: dict, w0: dict, calls: list, structures: list, tr: dict,
                   device) -> dict:
    """``judge``'s numbers, each the largest over the sampled ``calls``
    (dicts of structure index, seed, bucket, the PDB paths and the
    captured stage tensors)."""
    from port_bench.reference.generate import torsion_kwargs
    from port_bench.reference.model import HierCVAE
    from port_bench.reference.refine import torsion

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = HierCVAE(cfg).to(device)
    model.load_state_dict(w0)
    out: dict = {}
    for call in calls:
        s = structures[call["structure"]]
        L = len(s["seq_labels"])
        ref = reference_chain(model, s, call, tr, device)
        m = ref["mask"][:call["cartesian"].shape[1]]
        fin = torsion(call["cartesian"], m, **torsion_kwargs(tr))
        got = dict(call, rec=read_backbone(call["reconstruction"])[0],
                   models=read_backbone(call["ensemble"]))
        for k, v in judge(got, ref, fin, L).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


class Capture:
    """The refinement's start (the decoded ensemble), its Cartesian
    stage's output and its result in every call, taken at the boundaries
    of ``infer/generate.py``'s refinement (one device copy each)."""

    def __init__(self):
        from protein_ensemble_vae_torch.infer import generate as G

        self.start = self.cartesian = self.final = None
        inner_refine, inner_cart = G._refine_ensemble, G.refine_backbone

        def refine(n, ca, c, *args, **kwargs):
            self.start = torch.stack([n, ca, c]).detach().clone()
            out = inner_refine(n, ca, c, *args, **kwargs)
            self.final = torch.stack(list(out)).detach().clone()
            return out

        def cartesian(*args, **kwargs):
            out = inner_cart(*args, **kwargs)
            self.cartesian = torch.stack(list(out)).detach().clone()
            return out

        G._refine_ensemble, G.refine_backbone = refine, cartesian


def sample_calls(calls: list, lengths: list, n: int, rng: np.random.Generator) -> list:
    """``n`` of the finished calls: the first of the longest structure and
    others drawn by ``rng``, of other structures where there are enough."""
    longest = max(range(len(calls)), key=lambda k: (lengths[calls[k]["structure"]], -k))
    rest = [k for k in range(len(calls)) if k != longest]
    other = [k for k in rest if calls[k]["structure"] != calls[longest]["structure"]]
    pool = other if len(other) >= n - 1 else rest
    pick = list(rng.choice(pool, size=min(n - 1, len(pool)), replace=False))
    return [calls[k] for k in [longest] + sorted(int(k) for k in pick)]


def setup_model(cell, seed: int, device):
    import dataclasses

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models.vae import HierCVAE

    from port_bench.weights import make_weights

    mcfg = ModelConfig.from_dict(cell.config["model"])
    with torch.device(device):
        model = HierCVAE(mcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    w0 = make_weights(shapes, fold_seed(seed, 2), device)
    model.load_state_dict(w0)
    return model, w0, dataclasses.asdict(mcfg)


def _span_program(spans, model) -> None:
    """Under a trace: host spans around the calls into each layer of
    generation (encode, decode, refinement, gate, Kabsch, PDB writes)."""
    from protein_ensemble_vae_torch.infer import generate as G

    for name, attr in (("refine", "_refine_ensemble"), ("gate", "validate_protein_geometry"),
                       ("kabsch", "kabsch_rmsd"), ("kabsch", "pairwise_kabsch_rmsd"),
                       ("pdb_write", "write_pdb"), ("pdb_write", "write_multi_model_pdb"),
                       ("labels", "logits_to_labels")):
        setattr(G, attr, spans.wrap(name, getattr(G, attr)))
    model.encode = spans.wrap("encode", model.encode)
    model.decode = spans.wrap("decode", model.decode)


def run(cell, args, device, spans, profiler_ctx) -> dict:
    from protein_ensemble_vae_torch.data.collate import bucket_for
    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.utils.compile_cache import enable_compilation_cache

    from port_bench.harness import reduce_trace

    enable_compilation_cache()
    tr = cell.traffic
    buckets = tuple(tr["buckets"])
    phases = [("start", time.perf_counter())]
    model, w0, cfg = setup_model(cell, args.seed, device)
    lengths = log_uniform_lengths(*tr["lengths"], tr["structures"])
    rng = np.random.default_rng([args.seed, 1])
    structures = make_structures(lengths, 1, rng, cfg["seqemb_dim"], tr["fold_tries"], device)
    views = [_view(s, f"s{i:02d}") for i, s in enumerate(structures)]
    cycle = order(lengths, buckets)
    kw = _kwargs(tr)
    phases.append(("data and weights", time.perf_counter()))
    out_root = tempfile.mkdtemp(prefix="port_bench_gen_")
    try:
        seen = set()
        for i in sorted(range(len(lengths)), key=lambda i: -lengths[i]):
            b = bucket_for(lengths[i], buckets)
            if b not in seen:
                seen.add(b)
                generate_ensembles(model, views[i], os.path.join(out_root, f"warm{b}"),
                                   seed=fold_seed(args.seed, 5, b), **kw)
        phases.append(("warm-up calls", time.perf_counter()))
        if spans.traced:
            _span_program(spans, model)
        capture = Capture()
        calls, refine_s, residues = [], 0.0, 0
        spans.items.clear()
        with profiler_ctx as prof:
            with spans.span("window"):
                t0 = time.perf_counter()
                # a traced run stops after ``traced_calls``: the trace of one
                # polish call holds ~10^5 device events (its CUDA graphs'
                # kernels), and reading more would outlast the run's limit
                while time.perf_counter() < t0 + args.seconds and not (
                        spans.traced and len(calls) >= tr["traced_calls"]):
                    i = cycle[len(calls) % len(cycle)]
                    seed = fold_seed(args.seed, 6, len(calls))
                    d = os.path.join(out_root, f"call{len(calls):04d}")
                    with spans.span("generate"):
                        res = generate_ensembles(model, views[i], d, seed=seed, **kw)["results"][0]
                    refine_s += sum(res["refine_seconds"].values())
                    residues += res["length"] * res["n_samples"]
                    sid = res["structure"]
                    calls.append(dict(structure=i, seed=seed, bucket=bucket_for(lengths[i], buckets),
                                      ensemble=os.path.join(d, f"{sid}_ensemble.pdb"),
                                      reconstruction=os.path.join(d, f"{sid}_reconstruction.pdb"),
                                      start=capture.start, cartesian=capture.cartesian,
                                      final=capture.final))
                t1 = time.perf_counter()
        trace = reduce_trace(prof) if prof is not None else None
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        del model, views
        if device.type == "cuda":
            from protein_ensemble_vae_torch.infer.refine import clear_graphs

            clear_graphs()
            torch.cuda.empty_cache()
        check = sample_calls(calls, lengths, tr["checked_ensembles"],
                             np.random.default_rng([args.seed, 7]))
        t_ref = time.perf_counter()
        gaps = reference_gaps(cfg, w0, check, structures, tr, device)
        notes = [f"set-up: {a} {b - a0:.3f} s" for (_, a0), (a, b) in zip(phases, phases[1:])]
        notes.append(f"profiler stop and trace reduction: {t_ref - t1:.3f} s")
        notes.append(f"reference: {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    checks = [Check(k, v, cell.limits[k]) for k, v in gaps.items()]
    records = dict(kind="gen", window_s=t1 - t0, ensembles=len(calls), residues=residues,
                   refine_s=refine_s, trace=trace)
    return dict(t0=t0, window_s=t1 - t0, e2e={"gen_residues_per_s": residues / (t1 - t0)},
                attempted=len(calls), failed=0, checks=checks, records=records,
                memory_peak=peak, notes=notes)
