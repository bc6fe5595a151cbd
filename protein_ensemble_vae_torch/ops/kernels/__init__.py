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
                            "egnn_band_fwd_sm90": 0, "egnn_band_bwd_sm90": 0,
                            "egnn_band_fwd_sm90_hd512": 0, "egnn_band_bwd_sm90_hd512": 0,
                            "egnn_band_fwd_sm90_x3": 0, "egnn_band_bwd_sm90_x3": 0,
                            "egnn_band_fwd_sm90_wide": 0, "egnn_band_bwd_sm90_wide": 0,
                            "clash_fwd": 0, "clash_bwd": 0}

# The launches of kernels 1-2 (counted in LAUNCHES too) by mode,
# "<kernel>:<dtype of a / bs>/<precision>", e.g.
# "egnn_band_fwd:float32/highest", or "<kernel>:<dtype>/bfloat16_chain" in
# the bf16 edge chain (egnn_band.py: mode_key, _count); <kernel> is the
# one that served the mode, e.g. "egnn_band_fwd_sm90:bfloat16/default" for
# the one-pass fp32 chain at widths 32 to 256,
# "egnn_band_fwd_sm90_x3:float32/highest" for 3xTF32 there, or
# "egnn_band_fwd_sm90_hd512:float32/highest" for either fp32-chain mode at
# width 512, "egnn_band_fwd_sm90_wide:float32/highest" above it
# (egnn_band.py: band_kernel).
BAND_MODE_LAUNCHES: dict[str, int] = {}

# kernel -> its CUDA source, ``csrc/<source>.cu`` (one library per source;
# the shared-tile source serves width 512 and, under the ``_x3`` counters,
# 3xTF32 at the widths up to 256)
SOURCES: dict[str, str] = {"egnn_band_fwd": "egnn_band_fwd",
                           "egnn_band_bwd": "egnn_band_bwd",
                           "egnn_band_fwd_sm90": "egnn_band_fwd_sm90",
                           "egnn_band_bwd_sm90": "egnn_band_bwd_sm90",
                           "egnn_band_fwd_sm90_hd512": "egnn_band_fwd_sm90_hd512",
                           "egnn_band_bwd_sm90_hd512": "egnn_band_bwd_sm90_hd512",
                           "egnn_band_fwd_sm90_x3": "egnn_band_fwd_sm90_hd512",
                           "egnn_band_bwd_sm90_x3": "egnn_band_bwd_sm90_hd512",
                           "egnn_band_fwd_sm90_wide": "egnn_band_fwd_sm90_wide",
                           "egnn_band_bwd_sm90_wide": "egnn_band_bwd_sm90_wide",
                           "clash_fwd": "clash", "clash_bwd": "clash"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    BAND_MODE_LAUNCHES.clear()


OUTPUT_CHECK: Optional[Callable] = None


def check_outputs(name: str, *outs) -> None:
    if OUTPUT_CHECK is not None:
        OUTPUT_CHECK(name, outs)
