"""Host milliseconds per train step in the band kernels' wrappers (the
program's spans ``band.fwd`` and ``band.bwd`` around the host work of each
CUDA launch of kernels 1-2: checks, planning, scratch, weight images, the
launch), summed over the step's launches."""

from port_bench.program_spans import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, ("band.fwd", "band.bwd"))
