"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: a wrapper adds one where it launches its kernel, and nowhere else.
A run resets the counts with ``reset_launches()`` and reads them afterwards
to show that its path went through the kernels.

``check_outputs`` hands a kernel's outputs, once its autograd function has
them, to ``OUTPUT_CHECK`` (``utils.profiling.enable_debug_mode``'s NaN
check; None, and nothing is done, otherwise).
"""

from __future__ import annotations

from typing import Callable, Optional

LAUNCHES: dict[str, int] = {"egnn_band_fwd": 0, "egnn_band_bwd": 0,
                            "clash_fwd": 0, "clash_bwd": 0}

# The launches of kernels 1-2 (counted in LAUNCHES too) by mode,
# "<kernel>:<dtype of a / bs>/<precision>", e.g.
# "egnn_band_fwd:bfloat16/default", or "<kernel>:<dtype>/bfloat16_chain" in
# the bf16 edge chain (egnn_band.py: mode_key, _count).
BAND_MODE_LAUNCHES: dict[str, int] = {}

# kernel -> its CUDA source, ``csrc/<source>.cu`` (one library per source)
SOURCES: dict[str, str] = {"egnn_band_fwd": "egnn_band_fwd",
                           "egnn_band_bwd": "egnn_band_bwd",
                           "clash_fwd": "clash", "clash_bwd": "clash"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    BAND_MODE_LAUNCHES.clear()


OUTPUT_CHECK: Optional[Callable] = None


def check_outputs(name: str, *outs) -> None:
    if OUTPUT_CHECK is not None:
        OUTPUT_CHECK(name, outs)
