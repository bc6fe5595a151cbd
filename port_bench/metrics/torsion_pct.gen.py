"""Share of the traced generation window spent in the torsion stage of
refinement: the seconds of the program's ``refine.torsion`` spans (host
clock, each ending after a synchronise) over the window's seconds."""

from port_bench.program_spans import seconds, window_spans


def read(rec: dict):
    p = window_spans() if rec.get("kind") == "gen" else None
    if not p or not rec.get("window_s"):
        return None
    return 100.0 * seconds(p, ("refine.torsion",)) / rec["window_s"]
