"""CUDA graphs the refiners captured in the traced generation window, per
ensemble finished: the program's ``refine.capture`` spans (one per miss of
``adam_descent``'s graph cache). Set-up captures every shape the traffic
uses, so a cache that holds them reads 0."""

from port_bench.program_spans import window_spans


def read(rec: dict):
    p = window_spans() if rec.get("kind") == "gen" else None
    if not p or not rec.get("ensembles"):
        return None
    return sum(1 for s in p if s[0] == "refine.capture") / rec["ensembles"]
