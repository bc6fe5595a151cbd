"""Share of the generation window spent in refinement: the sum of
``generate_ensembles``' ``refine_seconds`` (host clock after a
synchronise) over the window's seconds."""


def read(rec: dict):
    if rec.get("kind") != "gen" or not rec.get("ensembles"):
        return None
    return 100.0 * rec["refine_s"] / rec["window_s"]
