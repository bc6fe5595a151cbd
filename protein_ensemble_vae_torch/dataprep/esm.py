"""ESM-2 per-residue embeddings -> H5 ``seq_embed`` groups.

Counterpart of the JAX package's ``dataprep/esm.py``: per-residue
layer-33 representations of ``esm2_t33_650M_UR50D`` with CLS/EOS
stripped, written gzip'd with metadata (incl. sequence md5) into
``seq_embed/esm2_t33_650M_UR50D/layer_33`` of each H5, with the same
group, attributes and skip / overwrite rules.

The forward is this package's own, ``models/esm2.ESM2Embedder``, on
``device``: the counterpart of the JAX package's default ``"jax"``
backend. The JAX package's HF-torch backend is not carried over: here both
would be PyTorch forwards of one function over the same HF weights, and
the tests hold the port's forward against HF's ``EsmModel`` instead.

The checkpoint weights come from the HF hub cache or a local path
(``facebook/esm2_t33_650M_UR50D``) through ``load_hf_esm2``; absent that,
a clear error notes the training path only *reads* precomputed
embeddings.

    python -m protein_ensemble_vae_torch.dataprep.esm \\
        --manifest_train data/manifest_train.csv [--device cpu]
"""

from __future__ import annotations

import csv
import hashlib
import os

import numpy as np

MODEL_NAME = "facebook/esm2_t33_650M_UR50D"
GROUP = "seq_embed/esm2_t33_650M_UR50D/layer_33"

_LOAD_HINT = ("could not load {name} (network/HF cache needed). "
              "Note: training only READS precomputed embeddings from H5 — "
              "run this step on a machine with the model available.")


class ESMEmbedder:
    """The ``model_name`` checkpoint on this package's ESM-2 forward, on
    ``device`` (default "cuda"; a CUDA device without a GPU raises)."""

    def __init__(self, model_name: str = MODEL_NAME, device: str = "cuda"):
        from protein_ensemble_vae_torch.models.esm2 import (ESM2Embedder,
                                                            load_hf_esm2)
        from protein_ensemble_vae_torch.ops.routing import resolve_device

        resolve_device(device)
        try:
            params, cfg = load_hf_esm2(model_name)
        except RuntimeError as e:
            raise RuntimeError(_LOAD_HINT.format(name=model_name)) from e
        self._embedder = ESM2Embedder(params, cfg, device=device)

    def embed(self, sequence: str) -> np.ndarray:
        """[L, 1280] layer-33 per-residue representations, CLS/EOS stripped
        (at most ``ESM2Config.max_tokens`` residues)."""
        return self._embedder.embed(sequence)


def add_embeddings_to_h5(h5_path: str, embedder, overwrite: bool = False,
                         verbose: bool = True) -> bool:
    """Write ``embedder.embed(sequence)`` into ``h5_path``'s ``GROUP``.
    ``embedder`` is anything with that method (``ESMEmbedder``,
    ``models/esm2.ESM2Embedder``). Skips a file that has the group (unless
    ``overwrite``) or no ``sequence``; returns whether it wrote."""
    from protein_ensemble_vae_torch.data import h5file

    with h5file.File(h5_path, "a") as fh:
        if GROUP in fh and not overwrite:
            if verbose:
                print(f"[esm] exists, skipping: {h5_path}")
            return False
        if "sequence" not in fh:
            if verbose:
                print(f"[esm] no sequence in {h5_path}")
            return False
        raw = fh["sequence"][()]
        seq = raw.decode() if isinstance(raw, (bytes, bytearray)) else str(raw)
        emb = embedder.embed(seq)
        if GROUP in fh:
            del fh[GROUP]
        ds = fh.create_dataset(GROUP, data=emb, compression="gzip")
        ds.attrs["model"] = MODEL_NAME
        ds.attrs["layer"] = 33
        ds.attrs["sequence_md5"] = hashlib.md5(seq.encode()).hexdigest()
        ds.attrs["dim"] = emb.shape[-1]
    if verbose:
        print(f"[esm] wrote {emb.shape} -> {h5_path}")
    return True


def embed_manifests(manifest_csvs: list[str], device: str = "cuda",
                    overwrite: bool = False) -> int:
    """Embed every H5 that the manifests name (each once) with
    ``ESMEmbedder(device=device)``; returns how many were written."""
    embedder = ESMEmbedder(device=device)
    done = 0
    seen = set()
    for manifest in manifest_csvs:
        with open(manifest) as f:
            for row in csv.DictReader(f):
                p = row["h5_path"].strip()
                if p in seen or not os.path.exists(p):
                    continue
                seen.add(p)
                if add_embeddings_to_h5(p, embedder, overwrite=overwrite):
                    done += 1
    return done


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Add ESM-2 embeddings to H5s")
    ap.add_argument("--manifest_train", default=None)
    ap.add_argument("--manifest_val", default=None)
    ap.add_argument("--manifest_test", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)

    manifests = [m for m in (args.manifest_train, args.manifest_val,
                             args.manifest_test) if m]
    if not manifests:
        ap.error("provide at least one manifest")
    n = embed_manifests(manifests, device=args.device,
                        overwrite=args.overwrite)
    print(f"[esm] embedded {n} H5 files")


if __name__ == "__main__":
    main()
