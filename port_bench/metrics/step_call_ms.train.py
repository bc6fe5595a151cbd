"""Mean host milliseconds inside each call of the train step that the
benchmark hands to ``run_epoch``. Beside the step's wall time it says
whether the host paces the step."""


def read(rec: dict):
    s = rec.get("step_call_s") if rec.get("kind") == "train" else None
    return 1e3 * sum(s) / len(s) if s else None
