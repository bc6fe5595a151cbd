"""Training runtime: the fused train / eval step and the epoch / fit loop
(counterpart of the JAX package's ``train/training.py``).

- One step: forward + the 16-term loss + backward + global-norm clip (10)
  + Adam moments + the finite-gradient skip, then the LR as a separate
  scalar multiply. The optimizer is written by hand to match optax's
  ``apply_if_finite(chain(clip_by_global_norm, scale_by_adam))`` exactly
  (``torch.optim.Adam`` and ``clip_grad_norm_`` place eps and skip
  differently).
- No host synchronisation inside a step: the finite check, the skip and the
  clip are tensor ops on the device; KL weights and the LR arrive as device
  scalars; metric sums stay on the device and are read once per epoch.
- The optimizer works on one flat fp32 vector: ``TrainState.create`` makes
  every parameter a (16-byte aligned) view into it, so the update is a
  handful of kernels rather than a few per parameter tensor.
- Pair semantics as in the reference: encode the input conformer,
  reconstruct the target conformer, the mask taken from the target.
- Randomness: reparameterisation noise and dropout come from torch's
  generators on the device, seeded per step from ``TrainConfig.seed``, the
  epoch, the batch index and the step count. Their bits differ from JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from protein_ensemble_vae_torch.config import LossWeights, RunConfig
from protein_ensemble_vae_torch.losses import (compute_total_loss,
                                               sequence_accuracy)
from protein_ensemble_vae_torch.train.kl_schedulers import create_kl_scheduler
from protein_ensemble_vae_torch.train.lr_schedule import ReduceLROnPlateau

Tensor = torch.Tensor

EPOCH_METRICS = ("loss", "rec", "pair", "klg", "kll", "dihedral", "rama",
                 "bond", "angle", "seq", "seq_acc", "clash")


def fold_seed(seed: int, *data: int) -> int:
    """A deterministic 63-bit seed from ``seed`` and ``data`` (the
    counterpart of ``jax.random.fold_in``)."""
    ss = np.random.SeedSequence([int(seed) & (2**63 - 1)] + [int(d) for d in data])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class TrainState:
    """Model, Adam moments, step, and the ``apply_if_finite`` counters.

    ``flat`` holds every parameter of ``model``; the parameters are views
    into it, each starting 16-byte aligned (the kernels read their weights
    with 16-byte loads), so ``flat`` has a few zero gaps. ``mu`` / ``nu``
    are the moments in the same layout, ``count`` the Adam count (advanced
    only by applied updates), ``step`` the step count (advanced by every
    train step, as ``TrainState.step`` in JAX; kept on the host, where it
    seeds the step's randomness)."""

    model: nn.Module
    params: list
    offsets: list
    flat: Tensor
    mu: Tensor
    nu: Tensor
    count: Tensor
    notfinite_count: Tensor
    last_finite: Tensor
    total_notfinite: Tensor
    gap: Tensor           # zeros for the alignment gaps of ``pack``
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module) -> "TrainState":
        params = list(model.parameters())
        offsets, off = [], 0
        for p in params:
            offsets.append(off)
            off += -(-p.numel() // 4) * 4
        dev = params[0].device
        flat = torch.zeros(off, dtype=torch.float32, device=dev)
        for p, o in zip(params, offsets):
            flat[o:o + p.numel()] = p.detach().reshape(-1)
            p.data = flat[o:o + p.numel()].view_as(p)
        i32 = dict(dtype=torch.int32, device=dev)
        return cls(model=model, params=params, offsets=offsets, flat=flat,
                   mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
                   count=torch.zeros((), **i32),
                   notfinite_count=torch.zeros((), **i32),
                   last_finite=torch.ones((), dtype=torch.bool, device=dev),
                   total_notfinite=torch.zeros((), **i32),
                   gap=torch.zeros(3, dtype=torch.float32, device=dev))

    def views(self, vec: Tensor) -> list:
        """``vec`` (in ``flat``'s layout) as one view per parameter."""
        return [vec[o:o + p.numel()].view_as(p) for o, p in zip(self.offsets, self.params)]

    def pack(self, tensors) -> Tensor:
        """One tensor per parameter -> a vector in ``flat``'s layout (one
        concatenation; the gaps are zero)."""
        parts = []
        for t, p in zip(tensors, self.params):
            parts.append(t.reshape(-1))
            pad = -p.numel() % 4
            if pad:
                parts.append(self.gap[:pad])
        return torch.cat(parts)

    def flat_grad(self) -> Tensor:
        """The gradients of all parameters in ``flat``'s layout (zeros
        where a parameter got none)."""
        return self.pack([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in self.params])

    _OPT_KEYS = ("mu", "nu", "count", "notfinite_count", "last_finite",
                 "total_notfinite")

    def optimizer_state(self) -> dict:
        """Moments, counters and step, on the CPU (for ``state.pt``)."""
        out = {k: getattr(self, k).detach().cpu() for k in self._OPT_KEYS}
        out["step"] = self.step
        return out

    def load_optimizer_state(self, d: dict) -> None:
        for k in self._OPT_KEYS:
            getattr(self, k).copy_(d[k])
        self.step = int(d["step"])


# optax.scale_by_adam defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The JAX package's ``make_optimizer``: optax
    ``apply_if_finite(chain(clip_by_global_norm(grad_clip), scale_by_adam()),
    max_consecutive_errors)``, on flat vectors.

    - clip: scale by grad_clip / ||g|| only when ||g|| >= grad_clip, as
      ``(g / ||g||) * grad_clip``, with no epsilon;
    - Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias correction
      by the count, update = mu_hat / (sqrt(nu_hat + eps_root) + eps);
    - skip: a step whose gradient holds a non-finite value changes neither
      the moments nor the count nor the parameters, and counts; after
      ``max_consecutive_errors`` such steps in a row the next is applied
      anyway, as optax does.
    """

    grad_clip: float = 10.0
    max_consecutive_errors: int = 100

    @torch.no_grad()
    def apply(self, state: TrainState, g: Tensor, lr) -> Tensor:
        """Update ``state`` in place from the flat gradient ``g``; ``lr``
        multiplies the Adam update (params += -lr * update). Returns the
        gradient's global norm (before clipping), on the device."""
        g_norm = torch.sqrt(torch.dot(g, g))
        finite = torch.isfinite(g).all()
        notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                state.notfinite_count + 1)
        accept = finite | (notfinite > self.max_consecutive_errors)

        trigger = g_norm < self.grad_clip
        one = torch.ones_like(g_norm)
        g = (g / torch.where(trigger, one, g_norm)) * torch.where(
            trigger, one, torch.full_like(g_norm, self.grad_clip))
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu
        count = state.count + 1
        c = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(torch.full_like(c, ADAM_B1), c))
        nu_hat = nu / (1 - torch.pow(torch.full_like(c, ADAM_B2), c))
        update = mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS)

        state.mu.copy_(torch.where(accept, mu, state.mu))
        state.nu.copy_(torch.where(accept, nu, state.nu))
        state.count.copy_(torch.where(accept, count, state.count))
        state.flat.add_(torch.where(accept, update, torch.zeros_like(update)) * (-lr))
        state.total_notfinite.copy_(torch.where(
            finite, state.total_notfinite, state.total_notfinite + 1))
        state.notfinite_count.copy_(notfinite)
        state.last_finite.copy_(finite)
        return g_norm


def batch_to_arrays(pair_batch, seqemb_dim: int) -> dict:
    """PairBatch -> {"inp": {...}, "tgt": {...}} of numpy arrays (zeros
    seq_emb when absent)."""
    def conv(c):
        seq_emb = c.seq_emb
        if seq_emb is None:
            seq_emb = np.zeros(c.ca.shape[:2] + (seqemb_dim,), np.float32)
        return dict(n=c.n, ca=c.ca, c=c.c, mask=c.mask, seq_emb=seq_emb,
                    dihedrals=c.dihedrals, seq_labels=c.seq_labels)

    return {"inp": conv(pair_batch.inp), "tgt": conv(pair_batch.tgt)}


def make_loss_fn(model: nn.Module, weights: LossWeights) -> Callable:
    """``loss_fn(batch, klw_g, klw_l, eps=None) -> (total, (loss_dict,
    seq_acc))`` on the model's current parameters and mode. ``eps`` =
    (eps_g, eps_l) replaces the reparameterisation draws."""

    def loss_fn(batch, klw_g, klw_l, eps=None):
        inp, tgt = batch["inp"], batch["tgt"]
        mask = tgt["mask"]
        pred_n, pred_ca, pred_c, pred_seq, mu_g, lv_g, mu_l, lv_l = model(
            inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
            mask, eps=eps)
        loss_dict = compute_total_loss(
            pred_n, pred_ca, pred_c, pred_seq,
            tgt["n"], tgt["ca"], tgt["c"], tgt["seq_labels"], mask,
            mu_g, lv_g, mu_l, lv_l, tgt["dihedrals"],
            klw_g=klw_g, klw_l=klw_l, weights=weights,
            use_pallas=model.config.use_pallas_egnn)
        seq_acc = sequence_accuracy(pred_seq, tgt["seq_labels"], mask)
        return loss_dict["total"], (loss_dict, seq_acc)

    return loss_fn


def step_metrics(loss_dict: dict, seq_acc: Tensor, grad_norm: Tensor) -> dict:
    """The 14 metrics of a step (device scalars, detached)."""
    m = {
        "loss": loss_dict["total"],
        "rec": loss_dict["reconstruction"],
        "pair": loss_dict["pair_distance"],
        "klg": loss_dict["kl_global"],
        "kll": loss_dict["kl_local"],
        "dihedral": loss_dict["dihedral_total"],
        "rama": loss_dict["ramachandran"],
        "bond": loss_dict["bond_length"],
        "angle": loss_dict["bond_angle"],
        "seq": loss_dict["sequence"],
        "seq_acc": seq_acc,
        "clash": loss_dict["clash"],
        "grad_norm": grad_norm,
        "rec_ca": loss_dict["reconstruction_ca"],
    }
    return {k: v.detach() for k, v in m.items()}


def make_train_step(model: nn.Module, weights: LossWeights, train: bool,
                    grad_clip: float = 10.0) -> Callable:
    """``step(state, batch, rng, klw_g, klw_l, lr) -> (state, metrics)``.

    ``batch`` is a dict of device tensors (``batch_to_arrays`` layout);
    ``rng`` an int seed (the epoch's seed folded with the batch index);
    ``klw_g``, ``klw_l``, ``lr`` device scalars. A train step updates
    ``state`` in place and advances ``state.step``; an eval step
    (``train=False``: dropout off, no gradient) leaves it as it is."""
    opt = Optimizer(grad_clip=grad_clip)
    loss_fn = make_loss_fn(model, weights)

    def step(state: TrainState, batch: dict, rng: int, klw_g, klw_l, lr):
        model.train(train)
        dev = state.flat.device
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(fold_seed(rng, state.step))
            if train:
                for p in state.params:
                    p.grad = None
                total, (loss_dict, seq_acc) = loss_fn(batch, klw_g, klw_l)
                total.backward()
            else:
                with torch.no_grad():
                    total, (loss_dict, seq_acc) = loss_fn(batch, klw_g, klw_l)
        if train:
            grad_norm = opt.apply(state, state.flat_grad(), lr)
            for p in state.params:
                p.grad = None
            state.step += 1
        else:
            grad_norm = torch.zeros((), device=dev)
        return state, step_metrics(loss_dict, seq_acc, grad_norm)

    return step


def run_epoch(state: TrainState, step_fn: Callable, batches: Iterable,
              rng: int, klw_g: float, klw_l: float, lr: float,
              seqemb_dim: int) -> tuple[TrainState, dict[str, float]]:
    """One epoch. Metric sums stay on the device; one host read at the end.
    Non-finite steps (skipped by the optimizer) are left out of the
    statistics; an epoch where most are non-finite raises."""
    from protein_ensemble_vae_torch.data.prefetch import prefetch_to_device

    dev = state.flat.device
    scal = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    klw_g, klw_l, lr = scal(klw_g), scal(klw_l), scal(lr)
    sums: Optional[dict] = None
    weight_sum = None
    n = 0
    converted = (batch_to_arrays(pb, seqemb_dim) for pb in batches)
    for batch_idx, batch in enumerate(prefetch_to_device(converted, dev)):
        bs = batch["tgt"]["ca"].shape[0]
        state, metrics = step_fn(state, batch, fold_seed(rng, batch_idx),
                                 klw_g, klw_l, lr)
        w = torch.isfinite(metrics["loss"]).to(torch.float32) * bs
        weighted = {k: torch.where(torch.isfinite(m), m, torch.zeros_like(m)) * w
                    for k, m in metrics.items()}
        sums = weighted if sums is None else {k: sums[k] + v for k, v in weighted.items()}
        weight_sum = w if weight_sum is None else weight_sum + w
        n += bs
    if sums is None:
        raise RuntimeError("empty epoch: no batches produced")
    keys = list(sums)
    host = torch.stack([sums[k] for k in keys] + [weight_sum]).cpu().numpy()
    n_valid = float(host[-1])
    if n_valid <= 0 or n_valid < 0.5 * n:
        raise ValueError(
            "Training collapsed - NaN/Inf loss in most steps of the epoch "
            f"({n - n_valid:.0f}/{n} samples non-finite)")
    stats = {k: float(v) / n_valid for k, v in zip(keys, host[:-1])}
    stats["nonfinite_frac"] = (n - n_valid) / n
    return state, stats


def train_model(model: nn.Module, train_ds, val_ds, run_config: RunConfig,
                logger=None, start_epoch: int = 1,
                init_state: Optional[TrainState] = None,
                checkpoint_fn: Optional[Callable] = None,
                make_batches: Optional[Callable] = None):
    """Full fit loop: KL annealing (the configured schedule), plateau LR,
    early stopping with best-parameter capture and restore, per-epoch
    logging. ``checkpoint_fn(state, epoch, loss_history, meta)`` is called
    on every validation improvement and every ``checkpoint_every`` epochs.
    ``make_batches`` replaces ``make_epoch_batches`` (same signature).
    Returns (state, loss_history)."""
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches

    tcfg, lw = run_config.train, run_config.loss
    seqemb_dim = run_config.model.seqemb_dim
    batch_factory = make_batches if make_batches is not None else make_epoch_batches
    state = init_state if init_state is not None else TrainState.create(model)

    train_step = make_train_step(model, lw, train=True, grad_clip=tcfg.grad_clip)
    eval_step = make_train_step(model, lw, train=False, grad_clip=tcfg.grad_clip)

    sched_kwargs = dict(warmup_epochs=tcfg.kl_warmup_epochs,
                        n_cycles=tcfg.kl_cycles, ratio=tcfg.kl_ratio)
    kl_g = create_kl_scheduler(tcfg.kl_schedule, max_weight=lw.klw_global,
                               **sched_kwargs)
    kl_l = create_kl_scheduler(tcfg.kl_schedule, max_weight=lw.klw_local,
                               **sched_kwargs)
    plateau = ReduceLROnPlateau(tcfg.lr, tcfg.plateau_factor,
                                tcfg.plateau_patience, tcfg.plateau_threshold,
                                tcfg.plateau_min_lr)

    loss_history = {
        "train": {k: [] for k in EPOCH_METRICS},
        "val": {k: [] for k in EPOCH_METRICS},
        "early_stopping": {"best_epoch": 0, "best_val_metric": float("inf"),
                           "metric_name": tcfg.early_stopping_metric},
    }
    best_metric = float("inf")
    best_epoch = 0
    best_params = None
    bad_epochs = 0
    last_val_rmsd = None

    def sched_meta(best: bool) -> dict:
        return {"kl_g": kl_g.get_state(), "kl_l": kl_l.get_state(),
                "plateau": plateau.get_state(), "best": best}

    for epoch in range(start_epoch, tcfg.epochs + 1):
        t0 = time.time()
        klw_g = kl_g.step(epoch, tcfg.epochs, val_rmsd=last_val_rmsd)
        klw_l = kl_l.step(epoch, tcfg.epochs, val_rmsd=last_val_rmsd)
        lr = plateau.lr

        tr_batches = batch_factory(train_ds, tcfg.batch_size, tcfg.bucket_sizes,
                                   True, tcfg.seed + epoch, drop_remainder=False)
        state, tr = run_epoch(state, train_step, tr_batches,
                              fold_seed(tcfg.seed, epoch, 0), klw_g, klw_l, lr,
                              seqemb_dim)
        va_batches = batch_factory(val_ds, tcfg.batch_size, tcfg.bucket_sizes,
                                   False, tcfg.seed, drop_remainder=False)
        _, va = run_epoch(state, eval_step, va_batches,
                          fold_seed(tcfg.seed, epoch, 1), klw_g, klw_l, lr,
                          seqemb_dim)

        for k in EPOCH_METRICS:
            loss_history["train"][k].append(tr[k])
            loss_history["val"][k].append(va[k])

        plateau.step(va["rec"])
        last_val_rmsd = float(np.sqrt(max(va["rec_ca"], 0.0)))

        if logger is not None:
            logger.log_epoch(epoch, tr, va, klw_g=klw_g, klw_l=klw_l,
                             lr=plateau.lr, seconds=time.time() - t0)

        metric_name = tcfg.early_stopping_metric
        current = last_val_rmsd if metric_name == "rmsd" else va[metric_name]
        if current < best_metric - tcfg.early_stopping_delta:
            best_metric = current
            best_epoch = epoch
            best_params = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
            bad_epochs = 0
            loss_history["early_stopping"].update(
                best_epoch=best_epoch, best_val_metric=best_metric)
            if checkpoint_fn is not None:
                checkpoint_fn(state, epoch, loss_history, sched_meta(True))
        else:
            bad_epochs += 1
            if bad_epochs >= tcfg.early_stopping_patience:
                if logger is not None:
                    logger.info(f"Early stopping at epoch {epoch} "
                                f"(best {metric_name}={best_metric:.6f} "
                                f"@ epoch {best_epoch})")
                break

        if (tcfg.checkpoint_every and checkpoint_fn is not None
                and epoch % tcfg.checkpoint_every == 0):
            checkpoint_fn(state, epoch, loss_history, sched_meta(False))

    if best_params is not None:
        model.load_state_dict(best_params)
    return state, loss_history
