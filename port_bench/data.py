"""Inputs made from the seed: folds, embeddings and sequences of the
traffic's structures, as the port's data layer hands them to the model
(each conformer centred on its CA centroid, dihedrals as sin/cos pairs)."""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.nerf import nerf_ensemble
from port_bench.reference.geometry import dihedrals_from_coords

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"


def log_uniform_lengths(lo: int, hi: int, n: int) -> list:
    """The n quantiles (i + 1/2) / n of a log-uniform length on [lo, hi]."""
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n * math.log(hi / lo))))
            for i in range(n)]


def make_structures(lengths, K: int, rng: np.random.Generator, seqemb_dim: int,
                    tries: int, device) -> list:
    """One dict per structure: ``conformers`` (K dicts of n, ca, c [L, 3],
    mask [L], dihedrals [L, 6]), ``seq_emb`` [L, seqemb_dim] (a random
    stand-in for ESM-2 embeddings), ``seq_labels`` [L] and ``sequence``."""
    out = []
    for L in lengths:
        x = nerf_ensemble(L, K, rng, tries=tries, device=device)       # [K, L, 3, 3]
        x = x - x[:, :, 1].mean(1)[:, None, None, :]
        xt = torch.from_numpy(x)
        mask = np.ones(L, np.float32)
        dih = dihedrals_from_coords(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2],
                                    torch.ones(K, L)).numpy()
        labels = rng.integers(0, 20, L).astype(np.int32)
        out.append(dict(
            conformers=[dict(n=x[k, :, 0], ca=x[k, :, 1], c=x[k, :, 2], mask=mask,
                             dihedrals=dih[k]) for k in range(K)],
            seq_emb=rng.standard_normal((L, seqemb_dim), dtype=np.float32),
            seq_labels=labels, sequence="".join(AA_ORDER[i] for i in labels)))
    return out
