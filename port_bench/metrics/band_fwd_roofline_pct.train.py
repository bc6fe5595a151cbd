"""Kernel 1's (the EGNN band forward's) share of its roofline in the traced
training window: the least time of its launches (``counts``: each launch's
FLOP over the TF32 peak or its bytes over the HBM rate, whichever is
larger) over the device time of the kernels whose names match it."""

import re


def read(rec: dict):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    pat = re.compile(rec["kernel_fwd"])
    spent = sum(s for n, s in t["kernel_s"].items() if pat.search(n))
    return 100.0 * rec["band_fwd_least_s"] / spent if spent > 0 else None
