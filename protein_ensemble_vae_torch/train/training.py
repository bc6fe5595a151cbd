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
- Parallelism (``parallel/mesh.py``): with a ``mesh`` a step is one rank's
  part of the dp x tp step. Its draws are the global batch's, cut to its
  rows; the loss normalisers are summed over the dp group, so its loss is
  its share of the global loss; the flat gradient and the metrics are
  summed over the dp group in one all-reduce (JAX's ``psum``); the clip's
  global norm sums the tp-sharded entries over the tp group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from protein_ensemble_vae_torch.config import LossWeights, RunConfig
from protein_ensemble_vae_torch.losses import (batch_denominators,
                                               compute_total_loss,
                                               sequence_accuracy)
from protein_ensemble_vae_torch.parallel.shard import draw_rows, tp_param_dim
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


def _pack(tensors, gap: Tensor) -> Tensor:
    """One vector of ``tensors``, each padded with zeros (from ``gap``) to a
    multiple of 4 elements: ``TrainState``'s flat layout."""
    parts = []
    for t in tensors:
        parts.append(t.reshape(-1))
        pad = -t.numel() % 4
        if pad:
            parts.append(gap[:pad])
    return torch.cat(parts)


def _unpack(vec: Tensor, shapes) -> list:
    """``_pack``'s inverse: one view of ``vec`` per shape."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(vec[off:off + n].view(shape))
        off += -(-n // 4) * 4
    return out


@dataclasses.dataclass
class TrainState:
    """Model, Adam moments, step, and the ``apply_if_finite`` counters.

    ``flat`` holds every parameter of ``model``; the parameters are views
    into it, each starting 16-byte aligned (the kernels read their weights
    with 16-byte loads), so ``flat`` has a few zero gaps. ``mu`` / ``nu``
    are the moments in the same layout, ``count`` the Adam count (advanced
    only by applied updates), ``step`` the step count (advanced by every
    train step, as ``TrainState.step`` in JAX; kept on the host, where it
    seeds the step's randomness). For a tp-sharded model ``flat`` holds
    this rank's shards and ``sharded`` marks their entries."""

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
    names: list = dataclasses.field(default_factory=list)
    sharded: Optional[Tensor] = None   # bool, flat's entries tp shards

    @classmethod
    def create(cls, model: nn.Module) -> "TrainState":
        named = list(model.named_parameters())
        params = [p for _, p in named]
        offsets, off = [], 0
        for p in params:
            offsets.append(off)
            off += -(-p.numel() // 4) * 4
        dev = params[0].device
        sharded = None
        if getattr(model, "tp", None) is not None:
            sharded = torch.zeros(off, dtype=torch.bool, device=dev)
            for (name, p), o in zip(named, offsets):
                if tp_param_dim(name, p.ndim) is not None:
                    sharded[o:o + p.numel()] = True
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
                   gap=torch.zeros(3, dtype=torch.float32, device=dev),
                   names=[name for name, _ in named], sharded=sharded)

    def views(self, vec: Tensor) -> list:
        """``vec`` (in ``flat``'s layout) as one view per parameter."""
        return [vec[o:o + p.numel()].view_as(p) for o, p in zip(self.offsets, self.params)]

    def pack(self, tensors) -> Tensor:
        """One tensor per parameter -> a vector in ``flat``'s layout (one
        concatenation; the gaps are zero)."""
        return _pack(tensors, self.gap)

    def flat_grad(self) -> Tensor:
        """The gradients of all parameters in ``flat``'s layout (zeros
        where a parameter got none)."""
        return self.pack([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in self.params])

    _OPT_KEYS = ("mu", "nu", "count", "notfinite_count", "last_finite",
                 "total_notfinite")

    def _full_shapes(self) -> list:
        tp = self.model.tp
        return [tuple(s * (tp.size if i == tp_param_dim(n, p.ndim) else 1)
                      for i, s in enumerate(p.shape))
                for n, p in zip(self.names, self.params)]

    def optimizer_state(self) -> dict:
        """Moments, counters and step, on the CPU (for ``state.pt``), the
        moments in the full model's layout: for a tp-sharded model the
        shards of the tp group gathered (a collective over that group)."""
        from protein_ensemble_vae_torch.models.bridge import gather_params

        out = {k: getattr(self, k).detach() for k in self._OPT_KEYS}
        if self.sharded is not None:
            for k in ("mu", "nu"):
                full = gather_params(dict(zip(self.names, self.views(out[k]))),
                                     self.model.tp)
                out[k] = _pack([full[n] for n in self.names], self.gap)
        out = {k: v.cpu() for k, v in out.items()}
        out["step"] = self.step
        return out

    def load_optimizer_state(self, d: dict) -> None:
        """``optimizer_state``'s inverse (moments in the full layout; a
        tp-sharded model keeps its shards of them)."""
        from protein_ensemble_vae_torch.models.bridge import shard_params

        d = dict(d)
        if self.sharded is not None:
            tp = self.model.tp
            for k in ("mu", "nu"):
                full = dict(zip(self.names, _unpack(d[k], self._full_shapes())))
                local = shard_params(full, tp.rank, tp.size)
                d[k] = self.pack([local[n] for n in self.names])
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
    def apply(self, state: TrainState, g: Tensor, lr,
              tp_sum: Optional[Callable] = None) -> Tensor:
        """Update ``state`` in place from the flat gradient ``g``; ``lr``
        multiplies the Adam update (params += -lr * update). Returns the
        gradient's global norm (before clipping), on the device. For a
        tp-sharded state, ``tp_sum`` sums over the tp group: the norm's
        square is the whole entries once plus the sharded entries' squares
        summed over the group, and the non-finite check counts every shard,
        so every rank of the group clips and skips alike."""
        if tp_sum is None:
            g_norm = torch.sqrt(torch.dot(g, g))
            finite = torch.isfinite(g).all()
        else:
            sh, zero = state.sharded, torch.zeros_like(g)
            sq = g * g
            part = tp_sum(torch.stack([
                torch.where(sh, sq, zero).sum(),
                (sh & ~torch.isfinite(g)).sum().to(g.dtype)]))
            g_norm = torch.sqrt(part[0] + torch.where(sh, zero, sq).sum())
            finite = torch.isfinite(torch.where(sh, zero, g)).all() & (part[1] == 0)
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


def make_loss_fn(model: nn.Module, weights: LossWeights,
                 dp_sum: Optional[Callable] = None) -> Callable:
    """``loss_fn(batch, klw_g, klw_l, eps=None) -> (total, (loss_dict,
    seq_acc))`` on the model's current parameters and mode. ``eps`` =
    (eps_g, eps_l) replaces the reparameterisation draws. With ``dp_sum``
    (a sum over the dp group) every term and ``seq_acc`` is normalised by
    the global batch's denominators: this batch's share of the global
    values."""

    def loss_fn(batch, klw_g, klw_l, eps=None):
        inp, tgt = batch["inp"], batch["tgt"]
        mask = tgt["mask"]
        pred_n, pred_ca, pred_c, pred_seq, mu_g, lv_g, mu_l, lv_l = model(
            inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
            mask, eps=eps)
        den = None
        if dp_sum is not None:
            den = dp_sum(batch_denominators(mask, pred_n, pred_ca, pred_c,
                                            tgt["dihedrals"], weights.pair_stride))
        loss_dict = compute_total_loss(
            pred_n, pred_ca, pred_c, pred_seq,
            tgt["n"], tgt["ca"], tgt["c"], tgt["seq_labels"], mask,
            mu_g, lv_g, mu_l, lv_l, tgt["dihedrals"],
            klw_g=klw_g, klw_l=klw_l, weights=weights,
            use_pallas=model.config.use_pallas_egnn, den=den)
        seq_acc = sequence_accuracy(pred_seq, tgt["seq_labels"], mask,
                                    None if den is None else den[1])
        return loss_dict["total"], (loss_dict, seq_acc)

    return loss_fn


def step_metrics(loss_dict: dict, seq_acc: Tensor) -> dict:
    """The metrics of a step but its gradient norm (device scalars,
    detached)."""
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
        "rec_ca": loss_dict["reconstruction_ca"],
    }
    return {k: v.detach() for k, v in m.items()}


def _dp_sum_with(g: Optional[Tensor], metrics: dict, dp_sum: Callable):
    """``g`` (or nothing) and the metrics summed over the dp group in one
    all-reduce; the metrics come back fp32."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
    buf = dp_sum(vals if g is None else torch.cat([g, vals]))
    vals = buf[buf.numel() - len(keys):]
    return (None if g is None else buf[:g.numel()]), dict(zip(keys, vals.unbind()))


def make_train_step(model: nn.Module, weights: LossWeights, train: bool,
                    grad_clip: float = 10.0, mesh=None) -> Callable:
    """``step(state, batch, rng, klw_g, klw_l, lr, eps=None) -> (state,
    metrics)``.

    ``batch`` is a dict of device tensors (``batch_to_arrays`` layout);
    ``rng`` an int seed (the epoch's seed folded with the batch index);
    ``klw_g``, ``klw_l``, ``lr`` device scalars; ``eps`` = (eps_g, eps_l) at
    the global batch's shape replaces the reparameterisation draws. A train
    step updates ``state`` in place and advances ``state.step``; an eval
    step (``train=False``: dropout off, no gradient) leaves it as it is.

    ``mesh`` (``parallel.make_mesh``; the model ``shard_model``-ed by it):
    the step is this rank's part of the dp x tp step, ``batch`` its rows of
    the global batch (``make_parallel_step`` cuts them), and the metrics
    are the global batch's on every rank. A mesh without a dp group
    (``Mesh.without_dp``) runs the whole batch on every dp rank."""
    opt = Optimizer(grad_clip=grad_clip)
    dp_sum = mesh.dp_sum if mesh is not None and mesh.dp_group is not None else None
    rows = (mesh.dp_rank, mesh.dp) if dp_sum is not None else (0, 1)
    tp_sum = mesh.tp_sum if getattr(model, "tp", None) is not None else None
    loss_fn = make_loss_fn(model, weights, dp_sum)

    def step(state: TrainState, batch: dict, rng: int, klw_g, klw_l, lr, eps=None):
        model.train(train)
        dev = state.flat.device
        if eps is not None and rows[1] > 1:
            eps = tuple(e.narrow(0, rows[0] * (e.shape[0] // rows[1]), e.shape[0] // rows[1])
                        for e in eps)
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), \
                draw_rows(model, *rows):
            torch.manual_seed(fold_seed(rng, state.step))
            if train:
                for p in state.params:
                    p.grad = None
                total, (loss_dict, seq_acc) = loss_fn(batch, klw_g, klw_l, eps)
                total.backward()
            else:
                with torch.no_grad():
                    total, (loss_dict, seq_acc) = loss_fn(batch, klw_g, klw_l, eps)
        metrics = step_metrics(loss_dict, seq_acc)
        if train:
            g = state.flat_grad()
            if dp_sum is not None:
                g, metrics = _dp_sum_with(g, metrics, dp_sum)
            metrics["grad_norm"] = opt.apply(state, g, lr, tp_sum)
            for p in state.params:
                p.grad = None
            state.step += 1
        else:
            if dp_sum is not None:
                _, metrics = _dp_sum_with(None, metrics, dp_sum)
            metrics["grad_norm"] = torch.zeros((), device=dev)
        return state, metrics

    return step


def run_epoch(state: TrainState, step_fn: Callable, batches: Iterable,
              rng: int, klw_g: float, klw_l: float, lr: float,
              seqemb_dim: int, dp: int = 1,
              fallback_step_fn: Optional[Callable] = None
              ) -> tuple[TrainState, dict[str, float]]:
    """One epoch. Metric sums stay on the device; one host read at the end.
    Non-finite steps (skipped by the optimizer) are left out of the
    statistics; an epoch where most are non-finite raises.

    Under dp (``dp > 1``) a batch whose size dp does not divide runs
    through ``fallback_step_fn`` (the whole batch on every dp rank) instead
    of being dropped, so eval statistics cover every sample."""
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
        fn = step_fn
        if dp > 1 and bs % dp != 0 and fallback_step_fn is not None:
            fn = fallback_step_fn
        state, metrics = fn(state, batch, fold_seed(rng, batch_idx),
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
                make_batches: Optional[Callable] = None,
                mesh=None, local_batches: bool = False):
    """Full fit loop: KL annealing (the configured schedule), plateau LR,
    early stopping with best-parameter capture and restore, per-epoch
    logging. ``checkpoint_fn(state, epoch, loss_history, meta)`` is called
    on every validation improvement and every ``checkpoint_every`` epochs.
    ``make_batches`` replaces ``make_epoch_batches`` (same signature).
    Returns (state, loss_history).

    With a ``mesh`` (this rank's; ``model`` sharded by it) every rank runs
    this loop: each gets the global batches and keeps its rows, or, with
    ``local_batches`` (multi-host: ``make_batches`` feeds each process its
    own shard), takes its batches as they come. Train remainders are
    dropped when dp > 1; a val batch dp does not divide runs whole on every
    rank (not with ``local_batches``). The statistics are the global
    batch's on every rank, so every rank stops on the same epoch."""
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches

    tcfg, lw = run_config.train, run_config.loss
    seqemb_dim = run_config.model.seqemb_dim
    batch_factory = make_batches if make_batches is not None else make_epoch_batches
    state = init_state if init_state is not None else TrainState.create(model)

    train_step = make_train_step(model, lw, train=True, grad_clip=tcfg.grad_clip,
                                 mesh=mesh)
    eval_step = make_train_step(model, lw, train=False, grad_clip=tcfg.grad_clip,
                                mesh=mesh)
    dp = mesh.dp if mesh is not None else 1
    eval_fallback = None
    if mesh is not None and not local_batches:
        from protein_ensemble_vae_torch.parallel.mesh import make_parallel_step

        wrap = make_parallel_step(mesh)
        train_step, eval_step = wrap(train_step), wrap(eval_step)
        if dp > 1:
            eval_fallback = make_train_step(model, lw, train=False,
                                            grad_clip=tcfg.grad_clip,
                                            mesh=mesh.without_dp())

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
                                   True, tcfg.seed + epoch, drop_remainder=dp > 1)
        state, tr = run_epoch(state, train_step, tr_batches,
                              fold_seed(tcfg.seed, epoch, 0), klw_g, klw_l, lr,
                              seqemb_dim)
        va_batches = batch_factory(val_ds, tcfg.batch_size, tcfg.bucket_sizes,
                                   False, tcfg.seed, drop_remainder=False)
        _, va = run_epoch(state, eval_step, va_batches,
                          fold_seed(tcfg.seed, epoch, 1), klw_g, klw_l, lr,
                          seqemb_dim, dp=dp, fallback_step_fn=eval_fallback)

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
