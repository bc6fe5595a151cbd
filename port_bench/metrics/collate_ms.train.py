"""Mean host milliseconds per step inside ``next()`` of the batch stream the
benchmark hands to ``run_epoch`` (the program's collate: padding and
stacking a batch of pairs)."""


def read(rec: dict):
    s = rec.get("collate_s") if rec.get("kind") == "train" else None
    return 1e3 * sum(s) / len(s) if s else None
