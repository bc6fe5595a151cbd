"""The controls and planted faults of ``correct``, run on the chip at a
cell's own size: ``python -m port_bench.controls.<driver> --workload
<cell> --seeds <n> ...`` prints one JSON line per seed with the readings of
the reference computed in TF32 in the program's place (the control) and
of the faults that need a run. The benchmark's own runs do not run them.
"""
