"""Synthetic protein folds for the benchmark's traffic: the port's
``data/synthetic.py:nerf_ensemble`` construction, frozen here and batched.

A fold is built by natural extension of reference frames (NeRF) from
torsions at ideal bond lengths and angles: helix segments of 10-17
residues at (-63, -43) degrees with 3 degrees of jitter, joined by loops of
3-5 residues at (-120, 140) with 8, trans omega. Of ``tries`` candidate
folds, those whose backbone atoms at least 2 residues apart all lie further
than 3.05 A apart are kept, and the most compact one is the base. Each
further conformer jitters the base's torsions (helix sd 1.5 degrees, loop
sd 5), is drawn again until it is free of clashes too, and is
Kabsch-aligned onto the base by its CAs.

Where the port's generator builds and checks one candidate at a time, this
one builds ``tries`` at once (one NeRF sweep over the residues, vectorised
over candidates) and checks their clashes on ``device``, so a run's set-up
makes 32 folds of up to 600 residues in seconds. It draws batches of
candidates until enough are free of clashes, ``ROUNDS`` at the most.
"""

from __future__ import annotations

import numpy as np
import torch

BOND_N_CA, BOND_CA_C, BOND_C_N = 1.46, 1.52, 1.33
ANGLE_N_CA_C, ANGLE_C_N_CA, ANGLE_CA_C_N = 110.0, 121.0, 116.0
ALPHA, BETA = (-63.0, -43.0), (-120.0, 140.0)
CLASH_FLOOR = 3.05
ROUNDS = 16          # batches of ``tries`` candidates drawn before giving up


def fold_torsions(L: int, rng: np.random.Generator) -> tuple[np.ndarray, ...]:
    """(phi, psi) in radians and the loop flag of one helix/loop layout."""
    phi, psi, loop = np.empty(L), np.empty(L), np.zeros(L, bool)
    i, helix = 0, True
    while i < L:
        seg = min(int(rng.integers(10, 18)) if helix else int(rng.integers(3, 6)), L - i)
        (ph0, ps0), jit = (ALPHA, 3.0) if helix else (BETA, 8.0)
        phi[i:i + seg] = ph0 + rng.normal(0, jit, seg)
        psi[i:i + seg] = ps0 + rng.normal(0, jit, seg)
        loop[i:i + seg] = not helix
        i += seg
        helix = not helix
    return np.radians(phi), np.radians(psi), loop


def _place(a, b, c, bond: float, angle_deg: float, tors):
    """Atom D [T, 3] from A, B, C [T, 3]: |CD| = bond, angle BCD, dihedral
    ABCD = tors [T]."""
    ang = np.radians(angle_deg)
    bc = c - b
    bc /= np.linalg.norm(bc, axis=-1, keepdims=True) + 1e-12
    nrm = np.cross(b - a, bc)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-12
    m = np.cross(nrm, bc)
    return (c - bond * np.cos(ang) * bc
            + (bond * np.sin(ang) * np.cos(tors))[:, None] * m
            + (bond * np.sin(ang) * np.sin(tors))[:, None] * nrm)


def build(phi: np.ndarray, psi: np.ndarray) -> np.ndarray:
    """Backbones [T, L, 3, 3] (N, CA, C) from torsions [T, L], trans omega."""
    T, L = phi.shape
    x = np.zeros((T, L, 3, 3))
    x[:, 0, 1] = (BOND_N_CA, 0.0, 0.0)
    a0 = np.radians(ANGLE_N_CA_C)
    x[:, 0, 2] = x[:, 0, 1] + BOND_CA_C * np.array([-np.cos(a0), np.sin(a0), 0.0])
    omega = np.full(T, np.pi)
    for i in range(L - 1):
        n, ca, c = x[:, i, 0], x[:, i, 1], x[:, i, 2]
        x[:, i + 1, 0] = _place(n, ca, c, BOND_C_N, ANGLE_CA_C_N, psi[:, i])
        x[:, i + 1, 1] = _place(ca, c, x[:, i + 1, 0], BOND_N_CA, ANGLE_C_N_CA, omega)
        x[:, i + 1, 2] = _place(c, x[:, i + 1, 0], x[:, i + 1, 1], BOND_CA_C, ANGLE_N_CA_C,
                                phi[:, i + 1])
    return x


def clash_free(x: np.ndarray, device) -> np.ndarray:
    """[T] bool: every pair of backbone atoms at least 2 residues apart
    lies further than CLASH_FLOOR apart."""
    T, L = x.shape[:2]
    atoms = torch.as_tensor(x.reshape(T, 3 * L, 3), dtype=torch.float32, device=device)
    res = torch.arange(3 * L, device=device) // 3
    near = (res[:, None] - res[None, :]).abs() < 2
    ok = []
    for t in range(T):
        d = torch.cdist(atoms[t], atoms[t]).masked_fill_(near, float("inf"))
        ok.append(d.min() > CLASH_FLOOR)
    return torch.stack(ok).cpu().numpy()


def _align(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    """``mobile`` [L, 3, 3] moved rigidly onto ``target`` by its CAs."""
    mu_m, mu_t = mobile[:, 1].mean(0), target[:, 1].mean(0)
    H = (mobile[:, 1] - mu_m).T @ (target[:, 1] - mu_t)
    U, _, Vt = np.linalg.svd(H)
    if np.linalg.det(Vt.T @ U.T) < 0:
        Vt = Vt.copy()
        Vt[-1, :] *= -1
    return (mobile - mu_m) @ (Vt.T @ U.T).T + mu_t


def nerf_ensemble(L: int, K: int, rng: np.random.Generator, tries: int = 16,
                  device="cpu") -> np.ndarray:
    """K clash-free conformers [K, L, 3, 3] of one fold, float32."""
    for _ in range(ROUNDS):
        layouts = [fold_torsions(L, rng) for _ in range(tries)]
        cand = build(np.stack([p for p, _, _ in layouts]), np.stack([s for _, s, _ in layouts]))
        ok = clash_free(cand, device)
        if ok.any():
            break
    else:
        raise RuntimeError(f"no clash-free fold of {L} residues in {ROUNDS} x {tries} tries")
    ca = cand[:, :, 1]
    rg = np.sqrt(((ca - ca.mean(1, keepdims=True)) ** 2).sum(-1).mean(-1))
    best = int(np.argmin(np.where(ok, rg, np.inf)))
    phi, psi, loop = layouts[best]
    base = cand[best]
    sd = np.radians(np.where(loop, 5.0, 1.5))
    out = [base]
    for _ in range(ROUNDS):
        need = K - len(out)
        if need == 0:
            break
        dphi, dpsi = rng.normal(0, sd, (need * tries, L)), rng.normal(0, sd, (need * tries, L))
        jit = build(phi + dphi, psi + dpsi)
        good = np.flatnonzero(clash_free(jit, device))[:need]
        out.extend(_align(jit[i], base) for i in good)
    if len(out) < K:
        raise RuntimeError(f"no clash-free conformer of {L} residues in {ROUNDS} rounds")
    return np.stack(out).astype(np.float32)
