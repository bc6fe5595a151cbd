"""Ensemble dataset: H5 reading, conformer records, pair enumeration.

A numpy copy of the JAX package's ``data/dataset.py`` (no JAX there, but
the port keeps its own copy); ``h5py`` is imported only by the H5 reader.

Host-side numpy re-design of reference ``models/data.py``. Matches its
semantics exactly:

- manifest CSV with an ``h5_path`` column; protein id = filename prefix
  before the first ``_`` (data.py:42)
- H5 schema: ``coords_N/ca/C [K, L, 3]``, ``mask_ca [K, L]``, optional
  ``seq_embed/esm2_t33_650M_UR50D/layer_33 [L, D]``,
  ``torsion_{phi,psi,omega}_sincos [K, L, 2]``, ``sequence`` (data.py:82-114)
- all unordered conformer pairs per protein are training items (data.py:62-76)
- per-conformer processing: center on valid-CA centroid, sequence -> int
  labels via the canonical AA table (data.py:157-194)

Additions for TPU: per-conformer length bucketing metadata (XLA static
shapes) and a clean single-conformer inference view — the reference's
generation path unpacks a pair 6-ways, a stale-API bug
(generate_ensemble_pdbs.py:401); ``SingleConformerView`` is the intended
behavior.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from protein_ensemble_vae_torch.config import AA_TO_IDX

ESM_GROUP = "seq_embed/esm2_t33_650M_UR50D/layer_33"


@dataclasses.dataclass
class Conformer:
    """One conformer of one protein chain (raw, uncentered)."""

    n: np.ndarray          # [L, 3]
    ca: np.ndarray         # [L, 3]
    c: np.ndarray          # [L, 3]
    mask: np.ndarray       # [L]
    seq_emb: Optional[np.ndarray]   # [L, D] or None (shared per protein)
    dihedrals: np.ndarray  # [L, 6] sin/cos phi,psi,omega
    sequence: Optional[str]
    protein_id: str
    h5_path: str

    @property
    def length(self) -> int:
        return int(self.mask.shape[0])


def _read_manifest(manifest_csv: str) -> list[str]:
    paths = []
    with open(manifest_csv, "r") as f:
        for row in csv.DictReader(f):
            p = row["h5_path"].strip()
            if p:
                paths.append(p)
    return paths


_TORSION_KEYS = ("torsion_phi_sincos", "torsion_psi_sincos",
                 "torsion_omega_sincos")


def _conformers_from_group(fh, protein_id: str, h5_path: str,
                           seq_emb, sequence) -> list[Conformer]:
    """Read one coords_N/ca/C + mask_ca (+torsion) group into Conformers."""
    n_coords = fh["coords_N"][:]
    ca_coords = fh["coords_ca"][:]
    c_coords = fh["coords_C"][:]
    mask = fh["mask_ca"][:]
    K, L, _ = ca_coords.shape

    dihedrals = None
    if all(k in fh for k in _TORSION_KEYS):
        dihedrals = np.concatenate([fh[k][:] for k in _TORSION_KEYS], axis=-1)

    out = []
    for k in range(K):
        if mask[k].sum() <= 0:
            continue
        dih_k = (dihedrals[k] if dihedrals is not None
                 else np.zeros((L, 6), np.float32))
        out.append(Conformer(
            n=n_coords[k].astype(np.float32),
            ca=ca_coords[k].astype(np.float32),
            c=c_coords[k].astype(np.float32),
            mask=mask[k].astype(np.float32),
            seq_emb=seq_emb,
            dihedrals=dih_k.astype(np.float32),
            sequence=sequence,
            protein_id=protein_id,
            h5_path=h5_path,
        ))
    return out


def _load_h5(h5_path: str, protein_id: str, use_seqemb: bool,
             use_crosspdb: bool = False) -> list[Conformer]:
    import h5py

    with h5py.File(h5_path, "r") as fh:
        seq_emb = None
        if use_seqemb and ESM_GROUP in fh:
            seq_emb = fh[ESM_GROUP][:].astype(np.float32)

        sequence = None
        if "sequence" in fh:
            raw = fh["sequence"][()]
            sequence = raw.decode("utf-8") if isinstance(raw, (bytes, bytearray)) else str(raw)

        out = _conformers_from_group(fh, protein_id, h5_path, seq_emb,
                                     sequence)
        # Cross-PDB conformers (same UniProt, >= 95 % identity, aligned into
        # the base frame at build time) join as extra pair partners. They
        # share the base chain's sequence labels / ESM embedding — justified
        # by the identity threshold.
        if use_crosspdb and "crosspdb" in fh:
            out += _conformers_from_group(fh["crosspdb"], protein_id,
                                          h5_path, seq_emb, sequence)
    return out


def sequence_to_labels(sequence: Optional[str], L: int) -> np.ndarray:
    """Canonical AA string -> int labels [L]; unknown/absent -> 0
    (reference data.py:180-192)."""
    labels = np.zeros(L, np.int32)
    if sequence:
        for i, aa in enumerate(sequence[:L]):
            labels[i] = AA_TO_IDX.get(aa, 0)
    return labels


def process_conformer(conf: Conformer) -> dict[str, np.ndarray]:
    """Center on valid-CA centroid (critical for the EGNN — preserves bond
    lengths, reference data.py:166-172) and build label arrays."""
    mask_b = conf.mask.astype(bool)
    n, ca, c = conf.n.copy(), conf.ca.copy(), conf.c.copy()
    if mask_b.any():
        centroid = conf.ca[mask_b].mean(axis=0)
        n -= centroid
        ca -= centroid
        c -= centroid
    return dict(
        n=n, ca=ca, c=c,
        mask=conf.mask,
        seq_emb=conf.seq_emb,
        dihedrals=conf.dihedrals,
        seq_labels=sequence_to_labels(conf.sequence, conf.length),
    )


class EnsembleDataset:
    """Pair-wise conformational ensemble dataset.

    Each item is an (input, target) pair of conformers of the same protein:
    encode the input, reconstruct the target (reference data.py:16-155).
    """

    def __init__(self, manifest_csv: str, use_seqemb: bool = True,
                 use_crosspdb: bool = False, verbose: bool = False):
        self.use_seqemb = use_seqemb
        self.use_crosspdb = use_crosspdb
        self.conformers: list[Conformer] = []
        self.proteins: dict[str, list[int]] = {}

        for h5_path in _read_manifest(manifest_csv):
            if not os.path.exists(h5_path):
                if verbose:
                    print(f"[data] H5 not found, skipping: {h5_path}")
                continue
            protein_id = os.path.basename(h5_path).replace(".h5", "").split("_")[0]
            start = len(self.conformers)
            self.conformers.extend(_load_h5(h5_path, protein_id, use_seqemb,
                                            use_crosspdb))
            self.proteins.setdefault(protein_id, []).extend(
                range(start, len(self.conformers)))

        if not self.conformers:
            raise RuntimeError(f"No data loaded from {manifest_csv}")

        # All unordered conformer pairs per protein (data.py:62-68).
        self.pairs: list[tuple[int, int]] = []
        for conf_ids in self.proteins.values():
            for i in range(len(conf_ids)):
                for j in range(i + 1, len(conf_ids)):
                    self.pairs.append((conf_ids[i], conf_ids[j]))
        if not self.pairs:
            raise RuntimeError(
                "No pairs could be created — every protein needs >= 2 conformers")

        if verbose:
            print(f"[data] {len(self.pairs)} pairs / "
                  f"{len(self.conformers)} conformers / "
                  f"{len(self.proteins)} proteins from {manifest_csv}")

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        i, j = self.pairs[idx]
        return (process_conformer(self.conformers[i]),
                process_conformer(self.conformers[j]))

    def pair_length(self, idx: int) -> int:
        return self.conformers[self.pairs[idx][0]].length

    @property
    def seqemb_dim(self) -> Optional[int]:
        for c in self.conformers:
            if c.seq_emb is not None:
                return int(c.seq_emb.shape[-1])
        return None


class SingleConformerView:
    """Per-structure inference view: one processed conformer per index.

    The intended API for generation/eval (fixes the reference's stale
    pair-unpack at generate_ensemble_pdbs.py:401).
    """

    def __init__(self, dataset: EnsembleDataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset.conformers)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        return process_conformer(self.dataset.conformers[idx])

    def conformer(self, idx: int) -> Conformer:
        return self.dataset.conformers[idx]

    def protein_indices(self) -> dict[str, list[int]]:
        return self.dataset.proteins
