"""The train step, plain PyTorch: the port's ``train/training.py`` step
(forward, the 16-term loss, backward, clip by global norm, Adam moments,
the finite-gradient skip, the learning rate) on the reference model, with
per-parameter optimizer state where the port keeps one flat vector.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.losses import compute_total_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def pad_batch(structures: list, pairs: list, buckets, device) -> dict:
    """The batch of ``pairs`` ((structure, input conformer, target
    conformer) indices into ``structures``) zero-padded to the smallest of
    ``buckets`` that holds the longest: {"inp", "tgt"} of n, ca, c [B, L,
    3], mask [B, L], seq_emb [B, L, D], dihedrals [B, L, 6] (float32) and
    seq_labels [B, L] (int32), on ``device``."""
    L_pad = min(b for b in buckets if b >= max(len(structures[p]["seq_labels"])
                                               for p, _, _ in pairs))
    out = {}
    for side, k in (("inp", 1), ("tgt", 2)):
        rows = [dict(structures[pr[0]]["conformers"][pr[k]], seq_emb=structures[pr[0]]["seq_emb"],
                     seq_labels=structures[pr[0]]["seq_labels"]) for pr in pairs]
        fields = {}
        for f in ("n", "ca", "c", "mask", "seq_emb", "dihedrals", "seq_labels"):
            a = np.asarray(rows[0][f])
            buf = np.zeros((len(rows), L_pad) + a.shape[1:],
                           np.int32 if f == "seq_labels" else np.float32)
            for r, row in enumerate(rows):
                buf[r, :len(row[f])] = row[f]
            fields[f] = torch.from_numpy(buf).to(device)
        out[side] = fields
    return out


def fold_seed(seed: int, *data: int) -> int:
    """The port's ``train.training.fold_seed``: a 63-bit seed from ``seed``
    and ``data``."""
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1)] + [int(d) for d in data])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class AdamState:
    """Moments and count per parameter (optax ``scale_by_adam``)."""

    def __init__(self, params):
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0


def loss_and_grads(model, batch: dict, seed: int, eps, klw_g: float, klw_l: float,
                   weights) -> tuple[float, list]:
    """The train step's loss and gradients, dropout on, its draws seeded
    with ``seed`` as the port's step seeds them."""
    params = list(model.parameters())
    dev = params[0].device
    inp, tgt = batch["inp"], batch["tgt"]
    model.train(True)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        out = model(inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
                    tgt["mask"], eps=eps)
        pred_n, pred_ca, pred_c, pred_seq, mu_g, lv_g, mu_l, lv_l = out
        total = compute_total_loss(pred_n, pred_ca, pred_c, pred_seq, tgt["n"], tgt["ca"],
                                   tgt["c"], tgt["seq_labels"], tgt["mask"], mu_g, lv_g,
                                   mu_l, lv_l, tgt["dihedrals"], klw_g=klw_g,
                                   klw_l=klw_l, weights=weights)["total"]
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return float(total.detach()), grads


@torch.no_grad()
def apply_update(params, grads, state: AdamState, lr: float, grad_clip: float) -> list:
    """Clip by the global norm (only at or above ``grad_clip``), then one
    Adam step of ``lr``; a non-finite gradient changes nothing. Returns the
    clipped gradients, as the optimizer takes them."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if not bool(torch.isfinite(g_norm)):
        return grads
    if float(g_norm) >= grad_clip:
        grads = [g / g_norm * grad_clip for g in grads]
    state.count += 1
    c1, c2 = 1 - ADAM_B1 ** state.count, 1 - ADAM_B2 ** state.count
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
        nu.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
        p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))
    return grads
