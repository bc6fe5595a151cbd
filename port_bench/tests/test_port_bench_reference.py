"""The plain reference against the port's plain path at a tiny size on the
CPU, and what the reference may import."""

from __future__ import annotations

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_MODEL
from port_bench.drivers.train import judge, leaf_norms
from port_bench.reference import train as RT
from port_bench.reference import refine as RR
from port_bench.reference.generate import decode
from port_bench.reference.geometry import dihedrals_from_coords
from port_bench.reference.model import HierCVAE as Ref
from port_bench.weights import make_weights


def _models(seed: int = 5):
    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models.vae import HierCVAE

    cfg = ModelConfig.from_dict(TINY_MODEL)
    port = HierCVAE(cfg)
    w0 = make_weights({n: tuple(p.shape) for n, p in port.named_parameters()}, seed, "cpu")
    port.load_state_dict(w0)
    ref = Ref(dataclasses.asdict(cfg))
    ref.load_state_dict(w0)
    return port, ref, w0, dataclasses.asdict(cfg)


def _batch(lengths, L, rng):
    from port_bench.nerf import nerf_ensemble

    d = {k: [] for k in ("n", "ca", "c", "mask", "seq_emb", "seq_labels")}
    for n in lengths:
        x = np.zeros((L, 3, 3), np.float32)
        x[:n] = nerf_ensemble(n, 1, rng, tries=4)[0]
        x[:n] -= x[:n, 1].mean(0)
        m = np.zeros(L, np.float32)
        m[:n] = 1
        for k, a in zip(("n", "ca", "c"), (x[:, 0], x[:, 1], x[:, 2])):
            d[k].append(a)
        d["mask"].append(m)
        d["seq_emb"].append(rng.standard_normal((L, 16), dtype=np.float32))
        d["seq_labels"].append(rng.integers(0, 20, L).astype(np.int32))
    b = {k: torch.from_numpy(np.stack(v)) for k, v in d.items()}
    b["dihedrals"] = dihedrals_from_coords(b["n"], b["ca"], b["c"], b["mask"])
    return b


def test_reference_train_steps_match_the_port_plain_path():
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.train.training import (TrainState, fold_seed,
                                                           make_train_step)

    port, ref, w0, cfg = _models()
    rng = np.random.default_rng(3)
    batch = {"inp": _batch([20, 24, 15], 24, rng), "tgt": _batch([20, 24, 15], 24, rng)}
    batch["tgt"]["mask"] = batch["inp"]["mask"]
    lw = LossWeights()
    state = TrainState.create(port)
    step = make_train_step(port, lw, train=True)
    scal = lambda v: torch.tensor(v)  # noqa: E731
    prog = dict(losses=[])
    for k in range(3):
        state, met = step(state, batch, 77, scal(1.0), scal(0.5), scal(3e-5))
        prog["losses"].append(float(met["loss"]))
        if k == 0:
            prog["grad"] = leaf_norms(dict(zip(state.names, state.views(state.mu / 0.1))))
    prog["change"] = leaf_norms({n: v - w0[n] for n, v in
                                 zip(state.names, state.views(state.flat))})
    params, names = list(ref.parameters()), [n for n, _ in ref.named_parameters()]
    adam, want = RT.AdamState(params), dict(losses=[])
    for k in range(3):
        assert fold_seed(77, k) == RT.fold_seed(77, k)
        loss, grads = RT.loss_and_grads(ref, batch, RT.fold_seed(77, k), None, 1.0, 0.5, lw)
        grads = RT.apply_update(params, grads, adam, 3e-5, 10.0)
        want["losses"].append(loss)
        if k == 0:
            want["grad"] = leaf_norms(dict(zip(names, grads)))
    want["change"] = leaf_norms({n: p.detach() - w0[n] for n, p in zip(names, params)})
    gaps = judge(prog, want)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-3


def test_reference_decode_matches_the_port():
    from protein_ensemble_vae_torch.infer import generate as G

    port, ref, _, _ = _models(9)
    rng = np.random.default_rng(4)
    b = _batch([20], 24, rng)
    inputs = [b[k] for k in ("seq_emb", "n", "ca", "c", "dihedrals")]
    rec, dec = decode(ref, inputs, b["mask"], num_samples=3, seed=11, temperature=0.7)
    port.eval()
    with torch.no_grad():
        gen = torch.Generator().manual_seed(11)
        z_g, z_l, mu_g, lv_g, mu_l, lv_l = port.encode(*inputs, b["mask"], generator=gen)
        prec = port.decode(z_g, z_l, b["mask"])
        eps_g = torch.randn((3,) + tuple(mu_g.shape[1:]), generator=gen)
        eps_l = torch.randn((3,) + tuple(mu_l.shape[1:]), generator=gen)
        n, ca, c, _ = port.decode(mu_g + 0.7 * eps_g * torch.exp(0.5 * lv_g),
                                  mu_l + 0.7 * eps_l * torch.exp(0.5 * lv_l),
                                  b["mask"].expand(3, 24))
    assert float((torch.stack([n, ca, c]) - dec).abs().max()) < 1e-5
    assert float((torch.stack(prec[:3], 2)[0] - rec).abs().max()) < 1e-5
    assert G.POLISH_CARTESIAN == __import__(
        "port_bench.reference.generate", fromlist=["x"]).POLISH_CARTESIAN


def _perturbed(B: int, L: int, n: int, seed: int) -> tuple:
    """Stacked N/CA/C [3, B, L, 3] of NeRF chains of ``n`` residues,
    jittered by 0.3 A, zero-padded to ``L``, and their mask [B, L]."""
    from port_bench.nerf import nerf_ensemble

    rng = np.random.default_rng(seed)
    x = np.zeros((B, L, 3, 3), np.float32)
    x[:, :n] = nerf_ensemble(n, B, rng, tries=4) + rng.normal(0, 0.3, (B, n, 3, 3))
    mask = np.zeros((B, L), np.float32)
    mask[:, :n] = 1
    return torch.from_numpy(x).permute(2, 0, 1, 3).contiguous(), torch.from_numpy(mask)


@pytest.mark.parametrize("n", [12, 20])
def test_reference_cartesian_stage_matches_the_port_plain_path(n):
    from protein_ensemble_vae_torch.infer.generate import POLISH_CARTESIAN
    from protein_ensemble_vae_torch.infer.refine import refine_backbone

    x, mask = _perturbed(3, 24, n, seed=n)
    w = dict(POLISH_CARTESIAN, steps=40)
    want = torch.stack(refine_backbone(*x.unbind(0), mask, **w))
    got = RR.cartesian(x, mask, w)
    assert float((got - want).abs().max()) < 1e-4
    assert float((got - x).abs().max()) > 1e-2        # it moved


@pytest.mark.parametrize("lr_decay", [False, True])
def test_reference_torsion_stage_matches_the_port_plain_path(lr_decay):
    from protein_ensemble_vae_torch.infer.torsion_refine import refine_torsions

    x, mask = _perturbed(2, 24, 20, seed=7)
    kw = dict(steps=30, lr=0.05, anchor_weight=0.05, w_rama=0.5, w_omega=0.25,
              w_clash_vdw=2.0, lr_decay=lr_decay)
    want = torch.stack(refine_torsions(*x.unbind(0), mask, vdw_include_o=True, **kw))
    got = RR.torsion(x, mask, include_o=True, **kw)
    assert float((got - want).abs().max()) < 1e-4
    f32 = RR.torsion(x, mask, include_o=True, nerf_dtype=torch.float32, **kw)
    assert 0.0 < float((f32 - got).abs().max())         # the control's rebuild differs


def test_reference_torsion_kwargs_are_the_port_polish_flags(monkeypatch):
    from protein_ensemble_vae_torch.infer import generate as G

    from port_bench.reference.generate import torsion_kwargs

    seen = {}
    monkeypatch.setattr(G, "refine_torsions", lambda n, ca, c, mask, **kw: seen.update(kw)
                        or (n, ca, c))
    monkeypatch.setattr(G, "refine_backbone", lambda n, ca, c, mask, **kw: (n, ca, c))
    tr = dict(refine_steps=150, refine_lr=0.05, refine_anchor=0.05, refine_w_rama=0.5,
              refine_kwargs=dict(w_angle=0.5, w_bond=1.0, w_clash_vdw=0.0, lr_decay=False))
    x = torch.zeros(1, 4, 3)
    G._refine_ensemble(x, x, x, torch.ones(1, 4), {}, mode="polish", steps=150, lr=0.05,
                       anchor=0.05, w_rama=0.5, kwargs=tr["refine_kwargs"])
    want = torsion_kwargs(tr)
    assert dict(seen, include_o=seen.pop("vdw_include_o")) == want


def test_reference_batches_match_the_program_collation():
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches
    from protein_ensemble_vae_torch.train.training import batch_to_arrays

    from port_bench.drivers.train import pair_set

    tr = dict(proteins=3, lengths=[12, 40], conformers=3, fold_tries=4)
    ds = pair_set(tr, 16, np.random.default_rng(2), "cpu")
    buckets = (16, 32, 48)
    batches = list(make_epoch_batches(ds, 4, buckets, True, 5, drop_remainder=True))
    assert len(batches) > 2
    for k, pb in enumerate(batches):
        want = batch_to_arrays(pb, 16)
        got = RT.pad_batch(ds.structures, ds.log[4 * k:4 * (k + 1)], buckets, "cpu")
        for side in ("inp", "tgt"):
            for f, a in want[side].items():
                assert got[side][f].dtype == torch.as_tensor(a).dtype, f
                assert np.array_equal(got[side][f].numpy(), a), (k, side, f)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "protein_ensemble_vae_tpu"}


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "protein_ensemble_vae_torch" not in _imports(path)
