"""The whole train step's share of the TF32 peak: the model FLOP of every
step in the window (``counts.train_step_flops``: forward and backward from
shapes and valid masks, no recomputation) over the window's seconds."""

from port_bench.peaks import PEAK_TF32_FLOPS


def read(rec: dict):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_TF32_FLOPS
