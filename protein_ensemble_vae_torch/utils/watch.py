"""Offline ``wandb.watch``: periodic parameter / gradient histogram dumps
(counterpart of the JAX package's ``utils/watch.py``).

Every N epochs ``pev-train --watch_every N`` writes
``<save>/watch/epoch_NNNNN.npz``: per parameter, a histogram and summary
statistics of its values and of one gradient of the first training batch,
taken with the train step's own loss (``make_param_grad_fn``; on the GPU
through the EGNN band and clash kernels, as the step goes). The layout is
the JAX package's: keys ``param/<name>/<stat>`` and ``grad/<name>/<stat>``
with stats ``counts`` (int64), ``edges`` (float32), ``mean std min max
l2`` (float64) and ``nonfinite`` (int64). ``<name>`` is the port's
parameter name (the ``state_dict`` key, ``a.b.weight``), which maps to
JAX's Flax path (``a/b/kernel``) as ``models/bridge.py`` maps the
weights; every statistic is independent of a tensor's layout, so a
transposed Dense kernel gives the same numbers.

Under ``--dp`` / ``--tp`` every rank takes the gradient of the whole first
batch (no dp sum), the tp shards of parameters and gradients are gathered
to full tensors (a tp collective, so every rank takes part), and rank 0
alone writes.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional

import numpy as np
import torch


def _as_numpy(named) -> dict[str, np.ndarray]:
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in named.items()}


def histogram_summaries(named: Mapping, bins: int = 64) -> dict[str, dict]:
    """Per tensor of ``named`` (name -> tensor or array, or a module's
    parameters): histogram (counts, edges) and scalar statistics of its
    finite values, and the number of non-finite ones."""
    out = {}
    for name, a in _as_numpy(named).items():
        a = a.astype(np.float64).ravel()
        finite = a[np.isfinite(a)]
        if finite.size == 0:
            finite = np.zeros(1)
        counts, edges = np.histogram(finite, bins=bins)
        out[name] = {
            "counts": counts.astype(np.int64),
            "edges": edges.astype(np.float32),
            "mean": float(finite.mean()),
            "std": float(finite.std()),
            "min": float(finite.min()),
            "max": float(finite.max()),
            "l2": float(np.sqrt((finite ** 2).sum())),
            # JAX's expression, kept as it is (a tensor with no finite
            # value counts one fewer)
            "nonfinite": int(a.size - finite.size) if finite.size != a.size
                         else int(np.sum(~np.isfinite(a))),
        }
    return out


def dump_watch_npz(path: str, params: Mapping, grads: Optional[Mapping] = None,
                   bins: int = 64) -> str:
    """Write parameter (and, given, gradient) histograms to ``path``
    (a compressed .npz)."""
    payload = {}
    for prefix, named in (("param", params), ("grad", grads)):
        if named is None:
            continue
        for name, h in histogram_summaries(named, bins).items():
            for k, v in h.items():
                payload[f"{prefix}/{name}/{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)
    return path


def make_watch_fn(model, train_ds, run_config, outdir: str, every: int,
                  logger=None) -> Optional[Callable]:
    """The ``watch_fn(state, epoch)`` hook of ``train_model``; None when
    ``every`` is 0. Every ``every`` epochs it takes the first batch of
    ``make_epoch_batches(train_ds, batch_size, bucket_sizes, False, seed)``,
    its gradient through ``make_param_grad_fn`` (the KL weights at their
    maxima, the draws seeded by ``fold_seed(seed, epoch)``, as JAX folds the
    epoch into its key), and writes ``<outdir>/epoch_NNNNN.npz``. It leaves
    the training run as it was (``make_param_grad_fn``)."""
    if not every:
        return None
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches
    from protein_ensemble_vae_torch.models.bridge import gather_params
    from protein_ensemble_vae_torch.train.training import (batch_to_arrays, fold_seed,
                                                           make_param_grad_fn)

    tcfg, weights = run_config.train, run_config.loss
    grad_fn = make_param_grad_fn(model, weights)
    tp = getattr(model, "tp", None)
    rank0 = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0

    def watch_fn(state, epoch: int) -> None:
        if epoch % every != 0:
            return
        first = next(iter(make_epoch_batches(train_ds, tcfg.batch_size,
                                             tcfg.bucket_sizes, False, tcfg.seed)))
        dev = next(model.parameters()).device
        batch = {side: {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
                 for side, d in batch_to_arrays(first, run_config.model.seqemb_dim).items()}
        grads = grad_fn(batch, fold_seed(tcfg.seed, epoch), weights.klw_global,
                        weights.klw_local)
        params = {k: p.detach() for k, p in model.named_parameters()}
        if tp is not None:
            params, grads = gather_params(params, tp), gather_params(grads, tp)
        if not rank0:
            return
        path = dump_watch_npz(os.path.join(outdir, f"epoch_{epoch:05d}.npz"), params,
                              grads)
        if logger is not None:
            logger.info(f"[watch] param/grad histograms -> {path}")

    return watch_fn
