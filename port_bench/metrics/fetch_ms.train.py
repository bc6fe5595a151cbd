"""Mean host milliseconds per train step inside ``next()`` of the port's
device stream in ``run_epoch`` (the program's span ``train.fetch``: batch
conversion, pinning, the enqueue of the H2D copies, and the collate beneath)."""

from port_bench.program_spans import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, ("train.fetch",))
