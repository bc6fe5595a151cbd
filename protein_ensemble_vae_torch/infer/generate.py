"""Ensemble generation: reconstruction + posterior-sampled conformers
(counterpart of the JAX package's ``infer/generate.py``).

Per structure: encode (posterior sample), decode the reconstruction at
B=1, then decode all ``num_samples`` ensemble latents in one batched
decode. Structures are padded to length buckets. Writes the ground-truth
PDB, the reconstruction PDB and a geometry-gated multi-model ensemble PDB,
records sequence recovery, Kabsch RMSD and ensemble diversity, and writes
a summary text file.

Everything runs on the model's device; random draws come from one
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from protein_ensemble_vae_torch.config import IDX_TO_AA
from protein_ensemble_vae_torch.data.collate import bucket_for
from protein_ensemble_vae_torch.infer.gate import validate_protein_geometry
from protein_ensemble_vae_torch.infer.pdb_io import write_multi_model_pdb, write_pdb
from protein_ensemble_vae_torch.infer.refine import refine_backbone
from protein_ensemble_vae_torch.infer.sequence import logits_to_labels
from protein_ensemble_vae_torch.infer.torsion_refine import refine_torsions
from protein_ensemble_vae_torch.models.vae import HierCVAE
from protein_ensemble_vae_torch.ops.geometry import kabsch_rmsd, pairwise_kabsch_rmsd
from protein_ensemble_vae_torch.ops.routing import set_full_fp32
from protein_ensemble_vae_torch.utils.profiling import span


def _pad(x: np.ndarray, L_pad: int) -> np.ndarray:
    pad = [(0, L_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def _timed(seconds: dict, stage: str, request: Optional[int], fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host-clock seconds (after the device
    has finished it) stored under ``seconds[stage]``, inside the span
    ``refine.<stage>`` of structure ``request``."""
    with span("refine." + stage, request):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if out[0].is_cuda:
            torch.cuda.synchronize(out[0].device)
        seconds[stage] = time.perf_counter() - t0
    return out


# The Cartesian stage of refine_mode "polish": fixed, exactly as measured
# in the sweep (runs/refine_sweep_polish.json); the refine_* arguments only
# shape the torsion stage that follows it.
POLISH_CARTESIAN = dict(steps=600, lr=0.05, anchor_weight=0.003, w_bond=4.0,
                        w_rama=2.0, w_omega=2.0, w_clash=5.0, w_angle=8.0,
                        w_clash_vdw=400.0, lr_decay=True)


def _refine_ensemble(n, ca, c, mask, seconds: dict, *, mode: str, steps: int,
                     lr: float, anchor: float, w_rama: float,
                     kwargs: Optional[dict], request: Optional[int] = None):
    """Generation-time refinement of the decoded ensemble, dispatched as
    the JAX package's ``generate_ensembles`` does; each stage's seconds go
    into ``seconds`` ("cartesian", "torsion"), its span carries the
    structure index ``request``."""
    if mode in ("torsion", "polish"):
        # NeRF-manifold refinement: exact covalent geometry by construction;
        # the Cartesian kwargs (w_angle/w_bond/...) don't apply on the
        # manifold. "polish" = the measured two-stage pipeline
        # (runs/refine_sweep_polish.json): the Cartesian vdW relaxation
        # first, then the manifold stage.
        if mode == "polish":
            n, ca, c = _timed(seconds, "cartesian", request, refine_backbone, n, ca, c,
                              mask, **POLISH_CARTESIAN)
        # As the reference has it: the generate CLI's defaults
        # (w_clash_vdw 0.0, lr_decay False) are forwarded here too.
        kw = {k: v for k, v in (kwargs or {}).items()
              if k in ("w_clash_vdw", "lr_decay")}
        return _timed(seconds, "torsion", request, refine_torsions, n, ca, c, mask,
                      steps=steps, lr=lr, anchor_weight=anchor, w_rama=w_rama,
                      w_omega=w_rama / 2.0, vdw_include_o=(mode == "polish"), **kw)
    return _timed(seconds, "cartesian", request, refine_backbone, n, ca, c, mask,
                  steps=steps, lr=lr, anchor_weight=anchor, w_rama=w_rama,
                  w_omega=w_rama, **(kwargs or {}))


@torch.no_grad()
def generate_ensembles(model: HierCVAE, view, output_dir: str,
                       num_samples: int = 10, seed: int = 0,
                       max_structures: Optional[int] = None,
                       buckets=(64, 128, 192, 256, 320, 384, 448, 512, 576, 640),
                       temperature: float = 1.0,
                       latent_source: str = "posterior",
                       seq_decode: str = "argmax",
                       refine_steps: int = 0,
                       refine_lr: float = 0.05,
                       refine_anchor: float = 0.05,
                       refine_w_rama: float = 0.5,
                       refine_kwargs: Optional[dict] = None,
                       refine_mode: str = "cartesian",
                       verbose: bool = True) -> dict:
    """Generate for the first ``max_structures`` structures of ``view``
    (a ``SingleConformerView``) into ``output_dir``. Returns
    ``dict(results=[...], summary_path=...)``; each result also holds
    ``refine_seconds``, the seconds of each refinement stage that ran.

    With ``refine_steps > 0`` the decoded ensemble is refined before the
    gate: ``refine_mode`` "cartesian" (``infer/refine.py``), "torsion"
    (``infer/torsion_refine.py``) or "polish" (a fixed 600-step Cartesian
    stage, then the torsion stage with the carbonyl O in the vdW term)."""
    if latent_source not in ("posterior", "prior"):
        raise ValueError(f"latent_source must be 'posterior' or 'prior', "
                         f"got {latent_source!r}")
    set_full_fp32()
    model.eval()
    device = next(model.parameters()).device
    os.makedirs(output_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    results = []

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n_structures = len(view)
    if max_structures is not None:
        n_structures = min(n_structures, max_structures)

    for idx in range(n_structures):
        item = view[idx]
        conf = view.conformer(idx)
        L = int(item["mask"].shape[0])
        L_pad = bucket_for(L, buckets)
        mask = _pad(item["mask"], L_pad)
        seq_emb = item["seq_emb"]
        if seq_emb is None:
            seq_emb = np.zeros((L, model.config.seqemb_dim), np.float32)
        args = [to_dev(_pad(a, L_pad)[None]) for a in
                (seq_emb, item["n"], item["ca"], item["c"], item["dihedrals"])]
        mask_t = to_dev(mask[None])

        z_g, z_l, mu_g, lv_g, mu_l, lv_l = model.encode(*args, mask_t,
                                                        generator=gen)

        # Reconstruction (posterior sample, as the reference forward does).
        rec_n, rec_ca, rec_c, rec_seq = model.decode(z_g, z_l, mask_t)

        pred_labels = logits_to_labels(rec_seq[0], seq_decode,
                                       generator=gen).cpu().numpy()
        true_labels = _pad(item["seq_labels"], L_pad)
        valid = mask > 0.5
        seq_recovery = float((pred_labels[valid] == true_labels[valid]).mean())
        pred_sequence = "".join(IDX_TO_AA[int(a)] for a in pred_labels[:L])

        rec_rmsd = float(kabsch_rmsd(rec_ca[0], args[2][0], mask_t[0]))

        sid = f"{conf.protein_id}_{idx:04d}"
        write_pdb(item["n"], item["ca"], item["c"], item["mask"],
                  os.path.join(output_dir, f"{sid}_true.pdb"),
                  sequence=conf.sequence, pdb_id=conf.protein_id,
                  title="GROUND TRUTH")
        write_pdb(rec_n[0, :L].cpu().numpy(), rec_ca[0, :L].cpu().numpy(),
                  rec_c[0, :L].cpu().numpy(), item["mask"],
                  os.path.join(output_dir, f"{sid}_reconstruction.pdb"),
                  sequence=pred_sequence, pdb_id=conf.protein_id,
                  title="RECONSTRUCTION")

        # Ensemble latents: one batched decode for all samples.
        eps_g = torch.randn((num_samples,) + tuple(mu_g.shape[1:]),
                            generator=gen, device=device)
        eps_l = torch.randn((num_samples,) + tuple(mu_l.shape[1:]),
                            generator=gen, device=device)
        if latent_source == "prior":
            # z ~ N(0, T^2 I) — HierCVAE.sample semantics
            zs_g = temperature * eps_g
            zs_l = temperature * eps_l
        else:
            zs_g = mu_g + temperature * eps_g * torch.exp(0.5 * lv_g)
            zs_l = mu_l + temperature * eps_l * torch.exp(0.5 * lv_l)
        mask_rep = mask_t.expand(num_samples, L_pad)
        ens_n_t, ens_ca_t, ens_c_t, ens_seq = model.decode(zs_g, zs_l, mask_rep)
        refine_seconds = {}
        if refine_steps > 0:
            ens_n_t, ens_ca_t, ens_c_t = _refine_ensemble(
                ens_n_t, ens_ca_t, ens_c_t, mask_rep, refine_seconds,
                mode=refine_mode, steps=refine_steps, lr=refine_lr,
                anchor=refine_anchor, w_rama=refine_w_rama,
                kwargs=refine_kwargs, request=idx)
        ens_n, ens_ca, ens_c = (a.cpu().numpy()
                                for a in (ens_n_t, ens_ca_t, ens_c_t))

        keep, reasons = [], []
        for s in range(num_samples):
            ok, reason = validate_protein_geometry(ens_ca[s], mask)
            (keep if ok else reasons).append(s if ok else reason)
        kept = keep if keep else list(range(num_samples))  # fall back: keep all

        # Posterior samples carry the reconstruction's sequence; prior
        # samples carry their own, so write the consensus (argmax of the
        # kept samples' mean logits) as the one SEQRES.
        if latent_source == "prior":
            cons = torch.argmax(ens_seq[kept].mean(0), dim=-1).cpu().numpy()
            ens_sequence = "".join(IDX_TO_AA[int(a)] for a in cons[:L])
        else:
            ens_sequence = pred_sequence
        write_multi_model_pdb(
            ens_n[kept][:, :L], ens_ca[kept][:, :L], ens_c[kept][:, :L],
            item["mask"], os.path.join(output_dir, f"{sid}_ensemble.pdb"),
            sequence=ens_sequence, pdb_id=conf.protein_id,
            title=f"GENERATED ENSEMBLE ({len(kept)} MODELS)")

        if len(kept) > 1:
            M = pairwise_kabsch_rmsd(ens_ca_t[kept], mask_t[0]).cpu().numpy()
            diversity = float(M[np.triu_indices(len(kept), k=1)].mean())
        else:
            diversity = 0.0

        results.append(dict(
            structure=sid, protein=conf.protein_id, length=L,
            reconstruction_rmsd=rec_rmsd, seq_recovery=seq_recovery,
            n_valid_samples=len(keep), n_samples=num_samples,
            diversity=diversity, gate_failures=reasons[:3],
            refine_seconds=refine_seconds))
        if verbose:
            print(f"[generate] {sid}: L={L} rec_rmsd={rec_rmsd:.3f}A "
                  f"seq_rec={seq_recovery:.3f} "
                  f"valid={len(keep)}/{num_samples} div={diversity:.3f}A")

    summary_path = os.path.join(output_dir, "generation_summary.txt")
    with open(summary_path, "w") as f:
        f.write("ENSEMBLE GENERATION SUMMARY\n")
        f.write("=" * 70 + "\n")
        for r in results:
            f.write(f"{r['structure']:24s} L={r['length']:4d} "
                    f"rec_rmsd={r['reconstruction_rmsd']:7.3f}A "
                    f"seq_recovery={r['seq_recovery']:.3f} "
                    f"valid={r['n_valid_samples']}/{r['n_samples']} "
                    f"diversity={r['diversity']:.3f}A\n")
        if results:
            f.write("-" * 70 + "\n")
            f.write(f"mean rec RMSD: "
                    f"{np.mean([r['reconstruction_rmsd'] for r in results]):.3f}A\n")
            f.write(f"mean seq recovery: "
                    f"{np.mean([r['seq_recovery'] for r in results]):.3f}\n")
            f.write(f"mean diversity: "
                    f"{np.mean([r['diversity'] for r in results]):.3f}A\n")
    return dict(results=results, summary_path=summary_path)
