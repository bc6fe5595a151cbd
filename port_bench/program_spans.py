"""The port's own spans, for the readers of the span metrics.

The port (``protein_ensemble_vae_torch.utils.profiling.span``) records a
span while a ``torch.profiler`` session runs, and a run of the benchmark
profiles its traced window alone, so after a traced run the port's
registry holds the window's spans: ``(name, start, end, parent,
request)``, seconds on ``time.perf_counter``, ``request`` the step index
in training and the structure index in generation. A port without the
registry gives None, and the readers then leave their metric out of the
line.
"""

from __future__ import annotations

from typing import Optional


def window_spans() -> Optional[list]:
    """The spans the port recorded in this process, or None where it
    records none or has no registry."""
    try:
        from protein_ensemble_vae_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def seconds(spans: list, names: tuple) -> float:
    """The seconds of the spans named in ``names``, summed."""
    return sum(s[2] - s[1] for s in spans if s[0] in names)


def per_step_ms(rec: dict, names: tuple) -> Optional[float]:
    """Host milliseconds per train step in the spans named in ``names``:
    their sum over the number of ``train.step`` spans."""
    p = window_spans() if rec.get("kind") == "train" else None
    if not p:
        return None
    steps = sum(1 for s in p if s[0] == "train.step")
    return 1e3 * seconds(p, names) / steps if steps else None
