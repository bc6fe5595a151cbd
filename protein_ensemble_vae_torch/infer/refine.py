"""Generation-time geometric refinement of sampled backbones (counterpart of
the JAX package's ``infer/refine.py``), and the Adam loop that both
refiners run.

Posterior-sampled conformers carry locally broken backbone geometry:
stretched peptide bonds and CA-CA spacings past the generator gate's 6 A
cutoff. ``refine_backbone`` relaxes the backbone coordinates under the
local-geometry energies (bond lengths, virtual CA-CA spacing, bond angles,
steric clash, the optional vdW term, Ramachandran basins and trans-omega
through the differentiable torsions) plus a soft anchor to the sampled
coordinates, batched over the whole ensemble.

``adam_descent`` is the loop, shared with ``infer/torsion_refine.py``. It
follows optax's ``adam`` exactly: b1 0.9, b2 0.999, eps 1e-8 outside the
square root of the bias-corrected second moment, no gradient clipping and
no skipping of non-finite steps (so it is not the training optimizer of
``train/training.py``), and with ``lr_decay`` optax's
``cosine_decay_schedule(lr, steps)`` read at the step count before its
increment. On a CUDA tensor one Adam step (the energy, its gradient by
autograd, the update in place, the step counter and cosine learning rate
on the device) is captured in a CUDA graph and replayed ``steps`` times:
the counterpart of the JAX package's one jitted ``lax.scan``. Graphs are
cached per static key (shapes, ``steps``, ``lr_decay``, the energy and its
on/off terms, device); weight values and ``lr`` are copied into the
graph's input buffers, so changing them never captures again. A failed
capture raises. On the CPU the same step runs eagerly in a Python loop.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import Callable, Optional

import torch

from protein_ensemble_vae_torch import losses as L
from protein_ensemble_vae_torch.ops.geometry import dihedrals_from_coords
from protein_ensemble_vae_torch.ops.kernels import LAUNCHES
from protein_ensemble_vae_torch.ops.kernels.clash import clash_loss_kernel
from protein_ensemble_vae_torch.ops.routing import pallas_policy

Tensor = torch.Tensor
Energy = Callable[[Tensor, dict], Tensor]

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults
WARMUP_STEPS = 2                 # eager steps on the capture stream first
MAX_GRAPHS = 8                   # captured steps kept, least recently used out


# ---------------------------------------------------------------------------
# The Adam loop
# ---------------------------------------------------------------------------

def _adam_step(energy: Energy, x: Tensor, consts: dict, m: Tensor, v: Tensor,
               count: Tensor, lr: Tensor, steps: int, lr_decay: bool) -> None:
    """One optax-adam step of ``energy`` at ``x``, in place on x, m, v and
    count (the steps taken so far, float32 on x's device). No host sync."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy(xg, consts), xg)
    with torch.no_grad():
        lr_t = lr
        if lr_decay:
            t = torch.clamp(count, max=float(steps))
            lr_t = lr * (0.5 * (1.0 + torch.cos(math.pi * t / steps)))
        count.add_(1.0)
        m.copy_((1.0 - B1) * g + B1 * m)
        v.copy_((1.0 - B2) * (g * g) + B2 * v)
        m_hat = m / (1.0 - B1 ** count)
        v_hat = v / (1.0 - B2 ** count)
        x.copy_(x - lr_t * (m_hat / (torch.sqrt(v_hat) + EPS)))


class _StepGraph:
    """One Adam step of an energy captured in a CUDA graph, with its input
    buffers (x, the energy's constants, lr) and its state (m, v, count).
    The constants are the graph's own copies, so every tensor a replay
    reads lives as long as the graph.

    Before capture the step runs ``WARMUP_STEPS`` times eagerly on the
    capture stream, so that the allocator's pools and the clash kernels'
    per-stream launch counters exist. Capture records the kernels without
    launching them, so the launch counts it added are taken back and each
    replay adds them again."""

    def __init__(self, energy: Energy, x0: Tensor, consts: dict, steps: int,
                 lr_decay: bool):
        dev = x0.device
        self.steps = steps
        self.x = x0.detach().clone()
        self.consts = {k: t.detach().clone() for k, t in consts.items()}
        self.m, self.v = torch.zeros_like(self.x), torch.zeros_like(self.x)
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)

        def step():
            _adam_step(energy, self.x, self.consts, self.m, self.v, self.count,
                       self.lr, steps, lr_decay)

        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                step()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        with torch.cuda.graph(self.graph, stream=stream):
            step()
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k, n in self.launches.items():
            LAUNCHES[k] -= n

    def run(self, x0: Tensor, consts: dict, lr: float) -> Tensor:
        self.x.copy_(x0)
        for k, t in consts.items():
            self.consts[k].copy_(t)
        self.lr.fill_(lr)
        for t in (self.m, self.v, self.count):
            t.zero_()
        for _ in range(self.steps):
            self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n * self.steps
        return self.x.clone()


_GRAPHS: "OrderedDict[tuple, _StepGraph]" = OrderedDict()


def clear_graphs() -> None:
    """Drop every cached graph and its memory pool."""
    _GRAPHS.clear()


def adam_descent(energy: Energy, x0: Tensor, consts: dict, lr: float, *,
                 steps: int, lr_decay: bool, key: tuple,
                 graph: Optional[bool] = None) -> Tensor:
    """Minimise ``energy(x, consts)`` from ``x0`` by ``steps`` optax-adam
    steps and return the last iterate.

    ``consts`` holds the tensors the energy reads besides x (reference
    coordinates, mask, weights). ``key`` names the energy and its static
    structure: with x0's and the constants' shapes, ``steps``,
    ``lr_decay`` and the device it keys the graph cache, so two energies
    must never share a key. ``graph`` (default: whether x0 lies on a CUDA
    device) runs the step from a CUDA graph; False runs it eagerly, also
    on the card."""
    if lr_decay and steps <= 0:
        raise ValueError(f"cosine decay needs steps > 0, got {steps}")
    if graph is None:
        graph = x0.is_cuda
    if steps <= 0:
        return x0.detach().clone()
    if not graph:
        x = x0.detach().clone()
        m, v = torch.zeros_like(x), torch.zeros_like(x)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=x.device)
        for _ in range(steps):
            _adam_step(energy, x, consts, m, v, count, lr_t, steps, lr_decay)
        return x
    if not x0.is_cuda:
        raise ValueError(f"a CUDA graph needs CUDA tensors; x0 lies on {x0.device}")
    full_key = (key, tuple(x0.shape), x0.dtype, x0.device, steps, lr_decay,
                tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(consts.items())))
    entry = _GRAPHS.get(full_key)
    if entry is None:
        entry = _StepGraph(energy, x0, consts, steps, lr_decay)
        _GRAPHS[full_key] = entry
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(full_key)
    return entry.run(x0, consts, lr)


# ---------------------------------------------------------------------------
# Cartesian refinement
# ---------------------------------------------------------------------------

ATOMS = ("n", "ca", "c")
WEIGHTS = ("anchor_weight", "w_bond", "bond_delta_scale", "w_spacing",
           "spacing_delta", "w_angle", "w_clash", "w_rama", "w_omega",
           "w_clash_vdw")


def _energy(coords: dict, ref: dict, mask: Tensor, w: dict, *, rama_on: bool,
            vdw_on: bool, use_pallas: object = "auto",
            vdw_tables: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """Local-geometry energy + soft anchor, as the JAX package's
    ``_energy``. Every term reuses the (masked, bounded-gradient) training
    losses with the deltas raised into their quadratic region. ``w`` holds
    the weights as 0-dim tensors; only ``rama_on`` and ``vdw_on`` are
    static. The clash term routes as the training loss does
    (``pallas_policy``, the knob of ``compute_total_loss``): kernels 3-4 on
    a CUDA tensor under "auto", the dense ``losses.clash_loss`` otherwise.
    ``vdw_tables`` is ``losses.vdw_pair_tables`` at this length."""
    n, ca, c = coords["n"], coords["ca"], coords["c"]
    if pallas_policy(mask, use_pallas):
        clash = clash_loss_kernel(n, ca, c, mask)
    else:
        clash = L.clash_loss(n, ca, c, mask)
    e = (w["w_bond"] * L.bond_length_loss(n, ca, c, mask,
                                          delta_scale=w["bond_delta_scale"])
         + w["w_spacing"] * L.ca_spacing_loss(ca, mask, delta=w["spacing_delta"])
         + w["w_angle"] * L.bond_angle_loss(n, ca, c, mask)
         + w["w_clash"] * clash)
    if vdw_on:
        # surrogate of the MolProbity counting event (vdW overlap >= 0.4 A,
        # 1-2/1-3/1-4 excluded), which the flat 3.2 A term above misses
        e = e + w["w_clash_vdw"] * L.vdw_clash_loss(n, ca, c, mask, tables=vdw_tables)
    if rama_on:
        dih = dihedrals_from_coords(n, ca, c, mask)
        e = (e + w["w_rama"] * L.ramachandran_loss(dih, mask)
             + w["w_omega"] * L.omega_trans_loss(dih, mask))
    msum = 3.0 * torch.clamp(torch.sum(mask), min=1.0)
    anchor = sum(torch.sum(torch.square(coords[k] - ref[k]) * mask[..., None])
                 for k in ATOMS) / msum
    return e + w["anchor_weight"] * anchor


def _stacked_energy(x: Tensor, consts: dict, **static) -> Tensor:
    """``_energy`` over x = stacked N/CA/C [3, B, L, 3] and the constants
    ``ref`` (the same layout), ``mask``, ``w`` (WEIGHTS in order) and, with
    the vdW term on, its pair tables ``vdw_pairs`` and ``vdw_thresh``."""
    tables = (consts["vdw_pairs"], consts["vdw_thresh"]) if static["vdw_on"] else None
    return _energy(dict(zip(ATOMS, x.unbind(0))),
                   dict(zip(ATOMS, consts["ref"].unbind(0))), consts["mask"],
                   dict(zip(WEIGHTS, consts["w"].unbind(0))), vdw_tables=tables,
                   **static)


def refine_backbone(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor, *,
                    steps: int = 150, lr: float = 0.05,
                    anchor_weight: float = 0.05, w_bond: float = 1.0,
                    bond_delta_scale: float = 50.0, w_spacing: float = 1.0,
                    spacing_delta: float = 3.0, w_angle: float = 0.5,
                    w_clash: float = 5.0, w_rama: float = 0.5,
                    w_omega: float = 0.5, w_clash_vdw: float = 0.0,
                    lr_decay: bool = False) -> tuple[Tensor, Tensor, Tensor]:
    """Relax backbone coordinates toward valid local geometry.

    Args:
      n, ca, c: ``[B, L, 3]`` backbone atom coordinates (any float dtype),
        on the device the refinement runs on.
      mask: ``[B, L]`` residue validity.
      steps: number of Adam iterations (static: part of the graph key).
      lr: Adam step size in A-ish units.
      anchor_weight: strength of the pull back to the input coordinates
        (per-atom mean squared A).
      lr_decay: cosine-anneal the step size to zero across ``steps``.

    Only ``steps``, ``lr_decay`` and the on/off structure of the torsion
    and vdW terms are static; every weight value (``lr`` included) is an
    input of the captured step.

    Returns:
      ``(n, ca, c)`` refined coordinates, the input's shapes and dtype;
      padded rows equal the input.
    """
    w = dict(anchor_weight=anchor_weight, w_bond=w_bond,
             bond_delta_scale=bond_delta_scale, w_spacing=w_spacing,
             spacing_delta=spacing_delta, w_angle=w_angle, w_clash=w_clash,
             w_rama=w_rama, w_omega=w_omega, w_clash_vdw=w_clash_vdw)
    return _refine(n, ca, c, mask, w, lr, steps=int(steps),
                   lr_decay=bool(lr_decay),
                   rama_on=(w_rama != 0.0 or w_omega != 0.0),
                   vdw_on=(w_clash_vdw != 0.0))


def _refine(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor, w: dict,
            lr: float, *, steps: int, lr_decay: bool, rama_on: bool,
            vdw_on: bool) -> tuple[Tensor, Tensor, Tensor]:
    """``refine_backbone`` with the weights as a dict."""
    dtype = ca.dtype
    x0 = torch.stack([n, ca, c]).to(torch.float32)
    maskf = mask.to(torch.float32)
    consts = dict(ref=x0, mask=maskf,
                  w=torch.tensor([float(w[k]) for k in WEIGHTS],
                                 dtype=torch.float32, device=x0.device))
    if vdw_on:
        consts["vdw_pairs"], consts["vdw_thresh"] = L.vdw_pair_tables(
            x0.shape[2], device=x0.device)
    static = dict(rama_on=rama_on, vdw_on=vdw_on)
    x = adam_descent(functools.partial(_stacked_energy, **static), x0, consts,
                     lr, steps=steps, lr_decay=lr_decay,
                     key=("cartesian",) + tuple(sorted(static.items())))
    # padded rows never accumulate force (every term is masked), but pin
    # them to the input exactly so downstream padding invariants hold
    m3 = maskf[..., None]
    out = x * m3 + x0 * (1.0 - m3)
    return tuple(t.to(dtype) for t in out.unbind(0))
