"""Length buckets (counterpart of the JAX package's ``data/collate.py``).

Structures are padded up to one of a few bucket lengths, so that every
structure of a bucket decodes at the same shape.
"""

from __future__ import annotations

from typing import Sequence


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"length {length} exceeds largest bucket {buckets[-1]}")
