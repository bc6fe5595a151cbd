"""Host milliseconds per ensemble in which the device idled: the traced
window's wall minus its device-busy time, per ensemble finished."""


def read(rec: dict):
    t = rec.get("trace")
    if rec.get("kind") != "gen" or not t or not rec.get("ensembles"):
        return None
    return 1e3 * (t["window_s"] - t["busy_s"]) / rec["ensembles"]
