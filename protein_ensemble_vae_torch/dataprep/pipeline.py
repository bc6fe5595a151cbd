"""Dataset-build pipeline: RCSB NMR ensembles -> aligned H5 + manifests.

Re-implements reference ``scripts/prepare_data.py`` (1137 LoC) host-side:

  query RCSB for NMR entries with >= min_models  (network, gated)
  -> download mmCIF with retry/backoff
  -> per chain: backbone extraction, missingness filter,
     medoid + core-fit alignment, RMSF, torsions, trRosetta pair features
  -> optional cross-PDB conformer augmentation (UniProt accession ->
     sequence search -> BLOSUM62 global alignment -> identity/coverage
     filter -> Kabsch into the base frame -> /crosspdb group)
  -> H5 files with the reference schema + 80/10/10 manifest CSVs

Network access is isolated in ``RCSBClient``; in offline environments every
step past download works from local mmCIF files (``build_from_files``), and
the synthetic fixture (``data.synthetic``) replaces the whole pipeline for
tests — the reference's own quality gates are kept.

Counterpart of the JAX package's ``dataprep/pipeline.py``: the backbone
torsions come from this package's ``ops/geometry.dihedrals_from_coords``
on ``device`` (default "cuda"; a CUDA device without a GPU raises), and
the H5 files and manifests have the same layout.

    python -m protein_ensemble_vae_torch.dataprep.pipeline --output data/ \
        --cif_files a.cif b.cif.gz [--device cpu]
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from protein_ensemble_vae_torch.dataprep.align import (
    alignment_identity_coverage,
    compute_rmsf_ensemble,
    core_fit_align,
    medoid_index,
    needleman_wunsch,
)
from protein_ensemble_vae_torch.dataprep.mmcif import (
    chain_to_arrays,
    parse_mmcif_backbone,
)
from protein_ensemble_vae_torch.dataprep.pair_features import compute_pair_features

RCSB_SEARCH_URL = "https://search.rcsb.org/rcsbsearch/v2/query"
RCSB_DOWNLOAD_URL = "https://files.rcsb.org/download/{pdb_id}.cif.gz"


class RCSBClient:
    """Thin HTTP client with retry/backoff (prepare_data.py:191-215)."""

    def __init__(self, max_retries: int = 4, backoff: float = 2.0,
                 timeout: float = 30.0):
        self.max_retries = max_retries
        self.backoff = backoff
        self.timeout = timeout

    def _request(self, url: str, payload: Optional[dict] = None) -> bytes:
        import urllib.error
        import urllib.request

        last = None
        for attempt in range(self.max_retries):
            try:
                if payload is not None:
                    req = urllib.request.Request(
                        url, data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"})
                else:
                    req = urllib.request.Request(url)
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return r.read()
            except Exception as e:  # noqa: BLE001 — retry everything
                last = e
                time.sleep(self.backoff ** attempt)
        raise RuntimeError(f"RCSB request failed after "
                           f"{self.max_retries} retries: {last}") from last

    def query_nmr_entries(self, min_models: int = 5,
                          max_entries: int = 1000) -> list[str]:
        """NMR entries with >= min_models deposited models."""
        payload = {
            "query": {"type": "group", "logical_operator": "and", "nodes": [
                {"type": "terminal", "service": "text", "parameters": {
                    "attribute": "exptl.method", "operator": "exact_match",
                    "value": "SOLUTION NMR"}},
                {"type": "terminal", "service": "text", "parameters": {
                    "attribute": "rcsb_nmr_ensemble.conformers_submitted_total_number",
                    "operator": "greater_or_equal", "value": min_models}},
            ]},
            "return_type": "entry",
            "request_options": {"paginate": {"start": 0, "rows": max_entries}},
        }
        data = json.loads(self._request(RCSB_SEARCH_URL, payload))
        return [hit["identifier"] for hit in data.get("result_set", [])]

    def download_mmcif(self, pdb_id: str, dest_dir: str) -> str:
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, f"{pdb_id.lower()}.cif.gz")
        if not os.path.exists(dest):
            data = self._request(
                RCSB_DOWNLOAD_URL.format(pdb_id=pdb_id.upper()))
            with open(dest, "wb") as f:
                f.write(data)
        return dest

    def search_entries_by_uniprot(self, accessions: Sequence[str],
                                  max_hits: int = 1000) -> list[str]:
        """PDB entries whose polymer entities map to any of the given UniProt
        accessions (reference find_crosspdb_candidates_by_uniprot,
        prepare_data.py:686-713, via rcsbapi; same query expressed directly
        against the JSON search API)."""
        if not accessions:
            return []
        payload = {
            "query": {"type": "group", "logical_operator": "and", "nodes": [
                {"type": "terminal", "service": "text", "parameters": {
                    "attribute": ("rcsb_polymer_entity_container_identifiers."
                                  "reference_sequence_identifiers.database_name"),
                    "operator": "exact_match", "value": "UniProt"}},
                {"type": "terminal", "service": "text", "parameters": {
                    "attribute": ("rcsb_polymer_entity_container_identifiers."
                                  "reference_sequence_identifiers."
                                  "database_accession"),
                    "operator": "in", "value": list(accessions)}},
                {"type": "terminal", "service": "text", "parameters": {
                    "attribute": "entity_poly.rcsb_entity_polymer_type",
                    "operator": "exact_match", "value": "Protein"}},
            ]},
            "return_type": "entry",
            "request_options": {"paginate": {"start": 0, "rows": max_hits}},
        }
        data = json.loads(self._request(RCSB_SEARCH_URL, payload))
        hits = [hit["identifier"] for hit in data.get("result_set", [])]
        out, seen = [], set()
        for h in hits:
            h = h.lower()
            if len(h) == 4 and h not in seen:
                out.append(h)
                seen.add(h)
        return out


def _torsions(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
              mask: np.ndarray, device: str) -> np.ndarray:
    """[K, L, 6] phi/psi/omega sin/cos of K conformers, computed on
    ``device`` by the shared geometry core."""
    import torch

    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.ops.geometry import dihedrals_from_coords

    dev = resolve_device(device)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
         for a in (n, ca, c, mask)]
    return dihedrals_from_coords(*t).cpu().numpy()


def process_chain(arrays: dict, max_missing_frac: float = 0.2,
                  min_len: int = 50, max_len: int = 600,
                  with_pair_features: bool = True,
                  device: str = "cuda") -> Optional[dict]:
    """Quality-gate + align + derive features for one chain ensemble.

    Gates mirror prepare_data.py:886-891,1119-1120: length in [50, 600],
    missing fraction below threshold, >= 2 conformers. The torsions are
    computed on ``device``.
    """
    mask = arrays["mask"]
    K, L = mask.shape
    if K < 2 or not (min_len <= L <= max_len):
        return None
    if 1.0 - mask.mean() > max_missing_frac:
        return None

    n, ca, c, med, core = core_fit_align(
        arrays["coords_n"], arrays["coords_ca"], arrays["coords_c"], mask)
    rmsf = compute_rmsf_ensemble(ca, mask)

    dih = _torsions(n, ca, c, mask, device)

    out = dict(
        coords_n=n, coords_ca=ca, coords_c=c, mask=mask,
        sequence=arrays["sequence"], resseqs=arrays["resseqs"],
        medoid=med, core_mask=core.astype(np.float32), rmsf=rmsf,
        torsion_phi_sincos=dih[..., 0:2], torsion_psi_sincos=dih[..., 2:4],
        torsion_omega_sincos=dih[..., 4:6])
    if with_pair_features:
        out["pair_features"] = compute_pair_features(
            n[med], ca[med], c[med], mask[med])
    return out


def append_crosspdb_conformers(base: dict, candidates: list[dict],
                               min_identity: float = 0.95,
                               min_coverage: float = 0.90,
                               max_models: int = 200,
                               min_common: int = 8,
                               device: str = "cuda") -> dict:
    """Cross-PDB augmentation: map candidate chains onto the base chain by
    BLOSUM62 global alignment, filter by identity/coverage (0.95/0.90 as in
    prepare_data.py:1010-1011), Kabsch each accepted conformer into the base
    frame over the base's *core* residues with >= ``min_common`` in common
    (prepare_data.py:770-778), cap at ``max_models``.

    ``candidates``: list of chain arrays dicts (like ``chain_to_arrays``),
    optionally carrying ``source`` (pdb:chain string) and ``meta`` (method/
    resolution/... dict). Returns stacked crosspdb coords + torsions + one
    meta record per accepted conformer; empty arrays when nothing passes.
    Beyond the reference (which keeps CA only, :806-815) the full N/CA/C
    backbone and torsions (computed on ``device``) are stored so crosspdb
    conformers can serve as training pair partners.
    """
    from protein_ensemble_vae_torch.dataprep.align import _kabsch_rt

    L = base["mask"].shape[1]
    med = base.get("medoid", 0)
    base_ca = base["coords_ca"][med]
    core = base.get("core_mask")
    fit_mask = ((base["mask"][med] > 0.5) if core is None
                else ((core > 0.5) & (base["mask"][med] > 0.5)))
    acc_n, acc_ca, acc_c, acc_mask, sources = [], [], [], [], []

    for cand in candidates:
        if len(acc_ca) >= max_models:
            break
        _, pairs = needleman_wunsch(base["sequence"], cand["sequence"])
        ident, cov = alignment_identity_coverage(
            base["sequence"], cand["sequence"], pairs)
        if ident < min_identity or cov < min_coverage:
            continue
        for k in range(cand["mask"].shape[0]):
            if len(acc_ca) >= max_models:
                break
            n_map = np.zeros((L, 3), np.float32)
            ca_map = np.zeros((L, 3), np.float32)
            c_map = np.zeros((L, 3), np.float32)
            m_map = np.zeros(L, np.float32)
            for i, j in pairs:
                if cand["mask"][k, j] > 0.5:
                    n_map[i] = cand["coords_n"][k, j]
                    ca_map[i] = cand["coords_ca"][k, j]
                    c_map[i] = cand["coords_c"][k, j]
                    m_map[i] = 1.0
            if m_map.sum() < min_common:
                continue
            shared = (m_map > 0.5) & fit_mask
            if shared.sum() < min_common:
                continue
            R, t = _kabsch_rt(ca_map[shared], base_ca[shared])
            for arr in (n_map, ca_map, c_map):
                arr[m_map > 0.5] = arr[m_map > 0.5] @ R.T + t
            acc_n.append(n_map)
            acc_ca.append(ca_map)
            acc_c.append(c_map)
            acc_mask.append(m_map)
            meta = dict(cand.get("meta") or {})
            ligs = meta.get("ligands", "")
            meta.update(
                source=cand.get("source", "unknown"),
                model_index=k,
                state=("apo" if not ligs else f"holo-{ligs}"),
                identity=float(ident), coverage=float(cov))
            sources.append(meta)

    if not acc_ca:
        return dict(coords_n=np.zeros((0, L, 3), np.float32),
                    coords_ca=np.zeros((0, L, 3), np.float32),
                    coords_c=np.zeros((0, L, 3), np.float32),
                    mask=np.zeros((0, L), np.float32), sources=[])

    out = dict(coords_n=np.stack(acc_n), coords_ca=np.stack(acc_ca),
               coords_c=np.stack(acc_c), mask=np.stack(acc_mask),
               sources=sources)

    # Torsions so crosspdb conformers are full training citizens.
    dih = _torsions(out["coords_n"], out["coords_ca"], out["coords_c"],
                    out["mask"], device)
    out["torsion_phi_sincos"] = dih[..., 0:2]
    out["torsion_psi_sincos"] = dih[..., 2:4]
    out["torsion_omega_sincos"] = dih[..., 4:6]
    return out


def candidates_from_cifs(cif_paths: Sequence[str],
                         verbose: bool = False) -> list[dict]:
    """Parse candidate mmCIF files into per-chain candidate dicts for
    ``append_crosspdb_conformers`` (single-model X-ray entries are fine:
    min_models=1). Attaches source id + entry metadata."""
    from protein_ensemble_vae_torch.dataprep.mmcif import extract_metadata

    out = []
    for cif in cif_paths:
        pdb_id = os.path.basename(cif).split(".")[0].lower()
        try:
            chains = parse_mmcif_backbone(cif)
            meta = extract_metadata(cif)
        except Exception as e:  # noqa: BLE001 — best-effort per candidate
            if verbose:
                print(f"[dataprep] crosspdb candidate parse failed {cif}: {e}")
            continue
        for chain_id, chain in chains.items():
            arrays = chain_to_arrays(chain, min_models=1)
            if arrays is None:
                continue
            arrays["source"] = f"{pdb_id}:{chain_id}"
            arrays["meta"] = meta
            out.append(arrays)
    return out


def discover_crosspdb(base_pdb_id: str, base_cif: str, client: "RCSBClient",
                      raw_dir: str, max_hits: int = 1000,
                      verbose: bool = False) -> list[dict]:
    """Online discovery: UniProt accessions from the base entry's mmCIF
    ``_struct_ref`` -> RCSB polymer-entity search -> download candidates
    (reference prepare_data.py:715-760). Returns candidate dicts; the base
    entry itself is excluded."""
    from protein_ensemble_vae_torch.dataprep.mmcif import uniprot_accessions

    accs = uniprot_accessions(base_cif)
    if not accs:
        return []
    cand_ids = [p for p in client.search_entries_by_uniprot(accs, max_hits)
                if p != base_pdb_id.lower()]
    if verbose:
        print(f"[dataprep] crosspdb {base_pdb_id}: UniProt {accs} -> "
              f"{len(cand_ids)} candidate entries")
    cifs = []
    for pid in cand_ids:
        try:
            cifs.append(client.download_mmcif(pid, raw_dir))
        except RuntimeError as e:
            if verbose:
                print(f"[dataprep] crosspdb download failed {pid}: {e}")
    return candidates_from_cifs(cifs, verbose=verbose)


def write_chain_h5(path: str, chain: dict,
                   crosspdb: Optional[dict] = None) -> str:
    """Write the reference H5 schema (prepare_data.py:957-995)."""
    from protein_ensemble_vae_torch.data import h5file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5file.File(path, "w") as fh:
        fh.create_dataset("coords_N", data=chain["coords_n"])
        fh.create_dataset("coords_ca", data=chain["coords_ca"])
        fh.create_dataset("coords_C", data=chain["coords_c"])
        fh.create_dataset("mask_ca", data=chain["mask"])
        fh.create_dataset("sequence", data=chain["sequence"])
        fh.create_dataset("resseqs", data=chain["resseqs"])
        fh.create_dataset("rmsf", data=chain["rmsf"])
        fh.create_dataset("core_mask", data=chain["core_mask"])
        fh.attrs["medoid"] = chain["medoid"]
        for k in ("torsion_phi_sincos", "torsion_psi_sincos",
                  "torsion_omega_sincos"):
            fh.create_dataset(k, data=chain[k])
        if "pair_features" in chain:
            g = fh.create_group("pair_features")
            for k, v in chain["pair_features"].items():
                g.create_dataset(k, data=v, compression="gzip")
        if crosspdb is not None and len(crosspdb["coords_ca"]):
            g = fh.create_group("crosspdb")
            g.create_dataset("coords_N", data=crosspdb["coords_n"])
            g.create_dataset("coords_ca", data=crosspdb["coords_ca"])
            g.create_dataset("coords_C", data=crosspdb["coords_c"])
            g.create_dataset("mask_ca", data=crosspdb["mask"])
            for k in ("torsion_phi_sincos", "torsion_psi_sincos",
                      "torsion_omega_sincos"):
                if k in crosspdb:
                    g.create_dataset(k, data=crosspdb[k])
            # per-conformer provenance records (reference meta_json,
            # prepare_data.py:780-815)
            g.attrs["sources"] = json.dumps(crosspdb["sources"])
    return path


def write_manifests(h5_paths: Sequence[str], out_dir: str, seed: int = 13,
                    splits: tuple[float, float, float] = (0.8, 0.1, 0.1)
                    ) -> dict[str, str]:
    """Shuffled 80/10/10 split manifests (prepare_data.py:1083-1098)."""
    rng = np.random.default_rng(seed)
    paths = list(h5_paths)
    rng.shuffle(paths)
    n = len(paths)
    n_train = int(n * splits[0])
    n_val = int(n * splits[1])
    groups = {
        "train": paths[:n_train],
        "val": paths[n_train:n_train + n_val],
        "test": paths[n_train + n_val:],
    }
    out = {}
    os.makedirs(out_dir, exist_ok=True)
    for name, group in groups.items():
        p = os.path.join(out_dir, f"manifest_{name}.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["h5_path"])
            for h in group:
                w.writerow([h])
        out[name] = p
    return out


def build_from_files(cif_paths: Sequence[str], output_dir: str,
                     min_models: int = 2, min_len: int = 50,
                     max_len: int = 600, max_missing_frac: float = 0.2,
                     with_pair_features: bool = True,
                     seed: int = 13, verbose: bool = True,
                     crosspdb_cifs: Optional[dict] = None,
                     crosspdb_online: bool = False,
                     crosspdb_identity: float = 0.95,
                     crosspdb_coverage: float = 0.90,
                     crosspdb_max_models: int = 200,
                     client: Optional["RCSBClient"] = None,
                     device: str = "cuda") -> dict[str, str]:
    """Offline build: local mmCIF files -> H5 + manifests.

    Cross-PDB augmentation (reference prepare_data.py:997-1016, best-effort):
    - ``crosspdb_cifs``: {base_pdb_id: [candidate cif paths]} for offline
      augmentation from local files;
    - ``crosspdb_online=True``: UniProt accession extraction + RCSB search +
      candidate download per entry (needs network).

    Torsions are computed on ``device``.
    """
    h5_paths = []
    for cif in cif_paths:
        pdb_id = os.path.basename(cif).split(".")[0]
        try:
            chains = parse_mmcif_backbone(cif)
        except Exception as e:
            if verbose:
                print(f"[dataprep] parse failed {cif}: {e}")
            continue

        # Gather cross-PDB candidates once per entry (shared across chains).
        candidates: list[dict] = []
        if crosspdb_cifs and pdb_id.lower() in {
                k.lower() for k in crosspdb_cifs}:
            paths = next(v for k, v in crosspdb_cifs.items()
                         if k.lower() == pdb_id.lower())
            candidates += candidates_from_cifs(paths, verbose=verbose)
        if crosspdb_online:
            try:
                candidates += discover_crosspdb(
                    pdb_id, cif, client or RCSBClient(),
                    os.path.join(output_dir, "cif_crosspdb"),
                    verbose=verbose)
            except Exception as e:  # noqa: BLE001 — optional, never fatal
                if verbose:
                    print(f"[dataprep] crosspdb discovery failed "
                          f"{pdb_id}: {e}")

        for chain_id, chain in chains.items():
            arrays = chain_to_arrays(chain, min_models=min_models)
            if arrays is None:
                continue
            processed = process_chain(arrays, max_missing_frac, min_len,
                                      max_len, with_pair_features, device)
            if processed is None:
                continue
            cross = None
            if candidates:
                # a candidate chain must not be the base chain itself
                own = f"{pdb_id.lower()}:{chain_id}"
                cands = [c for c in candidates if c.get("source") != own]
                cross = append_crosspdb_conformers(
                    processed, cands, min_identity=crosspdb_identity,
                    min_coverage=crosspdb_coverage,
                    max_models=crosspdb_max_models, device=device)
            h5 = os.path.join(output_dir, "h5",
                              f"{pdb_id}_{chain_id}_nmr.h5")
            write_chain_h5(h5, processed, crosspdb=cross)
            h5_paths.append(h5)
            if verbose:
                K, L = processed["mask"].shape
                n_cross = 0 if cross is None else len(cross["coords_ca"])
                print(f"[dataprep] {pdb_id}:{chain_id} K={K} L={L} "
                      f"medoid={processed['medoid']} crosspdb={n_cross} "
                      f"-> {h5}")
    if not h5_paths:
        raise RuntimeError("no chains passed the quality gates")
    return write_manifests(h5_paths, output_dir, seed=seed)


def build_dataset(output_dir: str, min_models: int = 5,
                  max_entries: int = 100, seed: int = 13,
                  verbose: bool = True, crosspdb: bool = False,
                  **gates) -> dict[str, str]:
    """Online build: query RCSB, download, then ``build_from_files``
    (``crosspdb=True`` enables same-UniProt conformer augmentation)."""
    client = RCSBClient()
    pdb_ids = client.query_nmr_entries(min_models=min_models,
                                       max_entries=max_entries)
    if verbose:
        print(f"[dataprep] {len(pdb_ids)} NMR entries from RCSB")
    cifs = []
    for pid in pdb_ids:
        try:
            cifs.append(client.download_mmcif(pid,
                                              os.path.join(output_dir, "cif")))
        except RuntimeError as e:
            if verbose:
                print(f"[dataprep] download failed {pid}: {e}")
    return build_from_files(cifs, output_dir, min_models=min_models,
                            seed=seed, verbose=verbose,
                            crosspdb_online=crosspdb, client=client, **gates)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Build the NMR ensemble dataset")
    ap.add_argument("--output", required=True)
    ap.add_argument("--min_models", type=int, default=5)
    ap.add_argument("--max_entries", type=int, default=100)
    ap.add_argument("--cif_files", nargs="*", default=None,
                    help="offline mode: local mmCIF files")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--crosspdb", action="store_true",
                    help="same-UniProt cross-PDB conformer augmentation "
                         "(accession search + candidate download)")
    ap.add_argument("--crosspdb_identity", type=float, default=0.95)
    ap.add_argument("--crosspdb_coverage", type=float, default=0.90)
    ap.add_argument("--crosspdb_max_models", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the torsions (default cuda; pass "
                         "cpu to run on the CPU)")
    args = ap.parse_args(argv)

    from protein_ensemble_vae_torch.ops.routing import resolve_device

    resolve_device(args.device)
    cross_kw = dict(crosspdb_identity=args.crosspdb_identity,
                    crosspdb_coverage=args.crosspdb_coverage,
                    crosspdb_max_models=args.crosspdb_max_models,
                    device=args.device)
    if args.cif_files:
        manifests = build_from_files(args.cif_files, args.output,
                                     min_models=args.min_models,
                                     seed=args.seed,
                                     crosspdb_online=args.crosspdb,
                                     **cross_kw)
    else:
        manifests = build_dataset(args.output, min_models=args.min_models,
                                  max_entries=args.max_entries,
                                  seed=args.seed, crosspdb=args.crosspdb,
                                  **cross_kw)
    print(f"[dataprep] manifests: {manifests}")


if __name__ == "__main__":
    main()
