"""Sequence encode / decode (counterpart of the JAX package's
``infer/sequence.py``).

- ``sequence_to_onehot``: AA string -> [L, 20] one-hot (numpy); unknown
  residues get uniform 1/20.
- ``logits_to_labels`` / ``tensor_to_sequence``: 'argmax', 'sample'
  (softmax + ``torch.multinomial`` with an explicit generator, the
  counterpart of ``jax.random.categorical`` with its key) and 'threshold'
  (greedy over classes whose probability clears ``threshold``, falling
  back to argmax).
- ``sequence_accuracy_vs_string``: argmax accuracy of [B, L, 20] logits
  against an AA string.
- ``to_3letter``: 1-letter string -> 3-letter codes, unknown -> ALA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from protein_ensemble_vae_torch.config import AA_1TO3, AA_TO_IDX, IDX_TO_AA

DECODE_METHODS = ("argmax", "sample", "threshold")


def sequence_to_onehot(sequence: str) -> np.ndarray:
    """AA string -> [L, 20] one-hot; unknown residues get uniform 1/20."""
    out = np.zeros((len(sequence), 20), np.float32)
    for i, aa in enumerate(sequence):
        j = AA_TO_IDX.get(aa)
        if j is None:
            out[i, :] = 1.0 / 20.0
        else:
            out[i, j] = 1.0
    return out


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


def tensor_to_sequence(logits, method: str = "argmax",
                       generator: Optional[torch.Generator] = None,
                       threshold: float = 0.5) -> str:
    """[L, 20] logits (tensor or array) -> AA string."""
    labels = logits_to_labels(torch.as_tensor(logits), method,
                              generator=generator, threshold=threshold)
    return "".join(IDX_TO_AA[int(i)] for i in labels.reshape(-1).tolist())


def sequence_accuracy_vs_string(pred_logits, target_sequence: str,
                                mask=None) -> float:
    """Argmax accuracy of [B, L, 20] logits against an AA string (unknown
    residues, encoded uniform, resolve to class 0 by argmax); ``mask``
    [B, L] restricts it to the valid positions (0.0 when none is)."""
    pred = torch.argmax(torch.as_tensor(pred_logits), dim=-1).cpu().numpy()
    tgt = sequence_to_onehot(target_sequence).argmax(-1)[None]   # [1, L]
    if mask is not None:
        valid = np.asarray(torch.as_tensor(mask).cpu()) > 0.5
        if valid.sum() == 0:
            return 0.0
        return float(((pred == tgt) & valid).sum() / valid.sum())
    return float((pred == tgt).mean())


def to_3letter(sequence: str) -> list[str]:
    """1-letter AA string -> 3-letter codes, unknown -> ALA."""
    return [AA_1TO3.get(aa, "ALA") for aa in sequence]
