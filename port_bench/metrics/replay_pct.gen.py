"""Share of the traced generation window that the host spent in the
refiners' replay loops: the seconds of the program's ``refine.replay``
spans (one around each ``adam_descent`` call's whole loop of CUDA graph
replays) over the window's seconds."""

from port_bench.program_spans import seconds, window_spans


def read(rec: dict):
    p = window_spans() if rec.get("kind") == "gen" else None
    if not p or not rec.get("window_s"):
        return None
    return 100.0 * seconds(p, ("refine.replay",)) / rec["window_s"]
