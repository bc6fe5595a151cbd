"""Mean host milliseconds per train step in ``total.backward()`` (the program's
span ``train.backward``; the main thread waits there while autograd's device
thread runs the backward)."""

from port_bench.program_spans import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, ("train.backward",))
