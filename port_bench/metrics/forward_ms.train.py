"""Mean host milliseconds per train step in the step's forward and loss (the
program's span ``train.forward`` around ``loss_fn`` in ``make_train_step``)."""

from port_bench.program_spans import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, ("train.forward",))
