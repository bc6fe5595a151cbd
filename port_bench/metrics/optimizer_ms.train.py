"""Mean host milliseconds per train step in the flat optimizer (the program's
span ``train.optimizer``: the flat gradient, the clip, Adam's update and the
gradient reset)."""

from port_bench.program_spans import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, ("train.optimizer",))
