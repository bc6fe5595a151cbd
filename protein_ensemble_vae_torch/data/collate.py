"""Length-bucketed padded batching (a numpy copy of the JAX package's
``data/collate.py``, ``make_sharded_epoch_batches`` included).

Lengths are padded up to a small set of bucket sizes, so every step of a
bucket runs at one shape and the batches are the JAX package's batches,
array for array. Pair batches keep the reference's (input, target) 7-field
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ConformerBatch:
    n: np.ndarray           # [B, L, 3]
    ca: np.ndarray          # [B, L, 3]
    c: np.ndarray           # [B, L, 3]
    mask: np.ndarray        # [B, L]
    seq_emb: Optional[np.ndarray]   # [B, L, D] or None
    dihedrals: np.ndarray   # [B, L, 6]
    seq_labels: np.ndarray  # [B, L] int32

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PairBatch:
    inp: ConformerBatch
    tgt: ConformerBatch


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"length {length} exceeds largest bucket {buckets[-1]}")


def pad_conformers(items: Sequence[dict], L_pad: int,
                   seqemb_dim: Optional[int]) -> ConformerBatch:
    """Pad a list of processed conformer dicts to [B, L_pad, ...]."""
    B = len(items)
    n = np.zeros((B, L_pad, 3), np.float32)
    ca = np.zeros((B, L_pad, 3), np.float32)
    c = np.zeros((B, L_pad, 3), np.float32)
    mask = np.zeros((B, L_pad), np.float32)
    dih = np.zeros((B, L_pad, 6), np.float32)
    labels = np.zeros((B, L_pad), np.int32)
    seq_emb = (np.zeros((B, L_pad, seqemb_dim), np.float32)
               if seqemb_dim else None)

    for i, it in enumerate(items):
        L = it["mask"].shape[0]
        n[i, :L] = it["n"]
        ca[i, :L] = it["ca"]
        c[i, :L] = it["c"]
        mask[i, :L] = it["mask"]
        dih[i, :L] = it["dihedrals"]
        labels[i, :L] = it["seq_labels"]
        if seq_emb is not None and it["seq_emb"] is not None:
            seq_emb[i, :L] = it["seq_emb"][:L]
    return ConformerBatch(n=n, ca=ca, c=c, mask=mask, seq_emb=seq_emb,
                          dihedrals=dih, seq_labels=labels)


def _make_chunks(dataset, batch_size: int, buckets: Sequence[int],
                 shuffle: bool, seed: int, drop_remainder: bool,
                 ) -> list[tuple[int, list[int]]]:
    """Deterministic (bucket, index-chunk) plan for one epoch.

    The plan depends only on (dataset order, batch_size, buckets, seed) so
    every process of a multi-host run computes the identical list."""
    by_bucket: dict[int, list[int]] = {}
    for idx in range(len(dataset)):
        b = bucket_for(dataset.pair_length(idx), buckets)
        by_bucket.setdefault(b, []).append(idx)

    rng = np.random.default_rng(seed)
    order = sorted(by_bucket)
    if shuffle:
        for b in order:
            rng.shuffle(by_bucket[b])

    chunks: list[tuple[int, list[int]]] = []
    for b in order:
        ids = by_bucket[b]
        for s in range(0, len(ids), batch_size):
            chunk = ids[s:s + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                continue
            chunks.append((b, chunk))
    if shuffle:
        rng.shuffle(chunks)
    return chunks


def _emit_batches(dataset, chunks, seqemb_dim) -> Iterator[PairBatch]:
    for L_pad, chunk in chunks:
        pairs = [dataset[i] for i in chunk]
        inp = pad_conformers([p[0] for p in pairs], L_pad, seqemb_dim)
        tgt = pad_conformers([p[1] for p in pairs], L_pad, seqemb_dim)
        yield PairBatch(inp=inp, tgt=tgt)


def make_epoch_batches(dataset, batch_size: int,
                       buckets: Sequence[int],
                       shuffle: bool,
                       seed: int,
                       drop_remainder: bool = False,
                       ) -> Iterator[PairBatch]:
    """Yield PairBatches grouped by length bucket.

    With ``drop_remainder`` the trailing partial batch of each bucket is
    dropped (use for throughput-critical training to keep one compiled shape
    per bucket); otherwise partial batches compile one extra variant each.
    """
    seqemb_dim = dataset.seqemb_dim if dataset.use_seqemb else None
    chunks = _make_chunks(dataset, batch_size, buckets, shuffle, seed,
                          drop_remainder)
    return _emit_batches(dataset, chunks, seqemb_dim)


def make_sharded_epoch_batches(dataset, batch_size: int,
                               buckets: Sequence[int],
                               shuffle: bool,
                               seed: int,
                               drop_remainder: bool = True,
                               process_index: int = 0,
                               process_count: int = 1,
                               ) -> Iterator[PairBatch]:
    """Per-process epoch batches for multi-host training (the JAX package's
    chunk plan, stride and shared permutation).

    Every process computes the same chunk plan and takes its stride of each
    bucket's chunks, truncated so all processes hold the same number of
    chunks per bucket in the same bucket order. Sample membership is
    shuffled per bucket with a process-identical RNG before any remainder
    is dropped, so with a per-epoch seed the dropped samples rotate across
    epochs. After the stride one process-identical permutation reorders the
    positions, so step i has the same padded shape on every process.

    ``drop_remainder`` is accepted for the factory signature; remainders
    are always dropped here, since equal chunk counts per bucket across
    processes keep the step shapes aligned."""
    seqemb_dim = dataset.seqemb_dim if dataset.use_seqemb else None
    ids_by_bucket: dict[int, list[int]] = {}
    for idx in range(len(dataset)):
        b = bucket_for(dataset.pair_length(idx), buckets)
        ids_by_bucket.setdefault(b, []).append(idx)
    if shuffle:
        rng = np.random.default_rng(seed)
        for b in sorted(ids_by_bucket):
            rng.shuffle(ids_by_bucket[b])
    mine: list[tuple[int, list[int]]] = []
    for b in sorted(ids_by_bucket):
        ids = ids_by_bucket[b]
        cs = [(b, ids[s:s + batch_size])
              for s in range(0, len(ids) - batch_size + 1, batch_size)]
        mine.extend(cs[process_index::process_count][:len(cs) // process_count])
    if shuffle:
        perm = np.random.default_rng(seed + 1).permutation(len(mine))
        mine = [mine[i] for i in perm]
    return _emit_batches(dataset, mine, seqemb_dim)


class PrepaddedStore:
    """One-time padded cache of every conformer, grouped by length bucket.

    ``make_epoch_batches`` re-pads every batch with Python loops each epoch;
    on a host with few cores that loop can rival the device step time. Here each
    conformer is processed (centered, labeled) and padded ONCE; per-epoch
    batch assembly is a handful of numpy fancy-index gathers — C-speed, no
    per-sample Python. ESM embeddings are stored once per (protein, bucket),
    not per conformer, which keeps the cache ~K× smaller than naive
    prepadding (K = conformers per protein).

    Epoch semantics (chunk plan, shuffling, drop_remainder) are identical to
    ``make_epoch_batches`` — both build on ``_make_chunks``.
    """

    def __init__(self, dataset, buckets: Sequence[int]):
        self.dataset = dataset
        self.buckets = tuple(buckets)
        self.seqemb_dim = dataset.seqemb_dim if dataset.use_seqemb else None

        by_bucket: dict[int, list[int]] = {}
        for idx in range(len(dataset)):
            b = bucket_for(dataset.pair_length(idx), buckets)
            by_bucket.setdefault(b, []).append(idx)

        self.store: dict[int, dict] = {}
        for b, pair_ids in by_bucket.items():
            conf_ids = sorted({c for p in pair_ids
                               for c in dataset.pairs[p]})
            row_of = {c: r for r, c in enumerate(conf_ids)}
            C = len(conf_ids)
            n = np.zeros((C, b, 3), np.float32)
            ca = np.zeros((C, b, 3), np.float32)
            cc = np.zeros((C, b, 3), np.float32)
            mask = np.zeros((C, b), np.float32)
            dih = np.zeros((C, b, 6), np.float32)
            labels = np.zeros((C, b), np.int32)
            embs: list[np.ndarray] = []
            # dedup key = identity of the shared per-chain embedding array
            # (conformers of one chain share the same seq_emb object); a
            # protein_id key would alias different CHAINS of one entry,
            # which carry different sequences/embeddings
            emb_row_of: dict[int, int] = {}
            emb_row = np.zeros(C, np.int64)
            from protein_ensemble_vae_torch.data.dataset import process_conformer
            for r, cid in enumerate(conf_ids):
                conf = dataset.conformers[cid]
                item = process_conformer(conf)
                L = item["mask"].shape[0]
                n[r, :L] = item["n"]
                ca[r, :L] = item["ca"]
                cc[r, :L] = item["c"]
                mask[r, :L] = item["mask"]
                dih[r, :L] = item["dihedrals"]
                labels[r, :L] = item["seq_labels"]
                if self.seqemb_dim:
                    key = id(conf.seq_emb)
                    if key not in emb_row_of:
                        e = np.zeros((b, self.seqemb_dim), np.float32)
                        if item["seq_emb"] is not None:
                            e[:L] = item["seq_emb"][:L]
                        emb_row_of[key] = len(embs)
                        embs.append(e)
                    emb_row[r] = emb_row_of[key]
            self.store[b] = dict(
                n=n, ca=ca, c=cc, mask=mask, dih=dih, labels=labels,
                emb=np.stack(embs) if embs else None, emb_row=emb_row,
                row_of=row_of)

    def _gather(self, st: dict, rows: np.ndarray) -> ConformerBatch:
        emb = None
        if st["emb"] is not None:
            emb = st["emb"][st["emb_row"][rows]]
        return ConformerBatch(
            n=st["n"][rows], ca=st["ca"][rows], c=st["c"][rows],
            mask=st["mask"][rows], seq_emb=emb,
            dihedrals=st["dih"][rows], seq_labels=st["labels"][rows])

    def epoch_batches(self, batch_size: int, shuffle: bool, seed: int,
                      drop_remainder: bool = False) -> Iterator[PairBatch]:
        chunks = _make_chunks(self.dataset, batch_size, self.buckets,
                              shuffle, seed, drop_remainder)
        pairs = self.dataset.pairs
        for b, chunk in chunks:
            st = self.store[b]
            rows_i = np.fromiter((st["row_of"][pairs[p][0]] for p in chunk),
                                 np.int64, len(chunk))
            rows_j = np.fromiter((st["row_of"][pairs[p][1]] for p in chunk),
                                 np.int64, len(chunk))
            yield PairBatch(inp=self._gather(st, rows_i),
                            tgt=self._gather(st, rows_j))


def make_prepadded_factory():
    """Drop-in replacement for ``make_epoch_batches`` with a per-dataset
    PrepaddedStore cache (built on first use, reused every epoch)."""
    cache: dict = {}

    def factory(dataset, batch_size, buckets, shuffle, seed,
                drop_remainder: bool = False):
        # keyed on id() but the cached dataset is held strongly and identity-
        # checked, so a recycled address after GC can't return a stale store
        key = (id(dataset), tuple(buckets))
        hit = cache.get(key)
        if hit is None or hit[0] is not dataset:
            hit = (dataset, PrepaddedStore(dataset, buckets))
            cache[key] = hit
        return hit[1].epoch_batches(batch_size, shuffle, seed,
                                    drop_remainder)

    return factory
