"""Share of the traced training window in which no operation ran on the
device: 100 - the union of device intervals over the window."""


def read(rec: dict):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
