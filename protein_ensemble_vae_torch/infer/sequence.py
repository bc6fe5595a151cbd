"""Sequence decoding (counterpart of the JAX package's ``infer/sequence.py``).

``logits_to_labels``: 'argmax', 'sample' (softmax + ``torch.multinomial``
with an explicit generator — the counterpart of ``jax.random.categorical``)
and 'threshold' (greedy over classes whose probability clears
``threshold``, falling back to argmax).
"""

from __future__ import annotations

from typing import Optional

import torch

DECODE_METHODS = ("argmax", "sample", "threshold")


def logits_to_labels(logits: torch.Tensor, method: str = "argmax",
                     generator: Optional[torch.Generator] = None,
                     threshold: float = 0.5) -> torch.Tensor:
    """[..., 20] logits -> [...] int labels under the chosen decode method."""
    if method == "argmax":
        return torch.argmax(logits, dim=-1)
    if method == "sample":
        if generator is None:
            raise ValueError("method='sample' needs a generator")
        probs = torch.softmax(logits.float(), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        draws = torch.multinomial(flat, 1, generator=generator)
        return draws.reshape(logits.shape[:-1])
    if method == "threshold":
        probs = torch.softmax(logits.float(), dim=-1)
        cleared = torch.where(probs >= threshold, probs,
                              torch.full_like(probs, float("-inf")))
        any_cleared = torch.isfinite(cleared).any(dim=-1)
        return torch.where(any_cleared, torch.argmax(cleared, dim=-1),
                           torch.argmax(logits, dim=-1))
    raise ValueError(f"Unknown method: {method!r} "
                     f"(expected one of {DECODE_METHODS})")
