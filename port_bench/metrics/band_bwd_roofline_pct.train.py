"""Kernel 2's (the EGNN band backward's, all of its passes) share of its
roofline in the traced training window: the least time of its launches
(``counts``) over the device time of the kernels whose names match it."""

import re


def read(rec: dict):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    pat = re.compile(rec["kernel_bwd"])
    spent = sum(s for n, s in t["kernel_s"].items() if pat.search(n))
    return 100.0 * rec["band_bwd_least_s"] / spent if spent > 0 else None
