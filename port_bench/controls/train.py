"""Readings of a training cell's control and faults, from the reference
alone: the checked steps of the run's stream (its first batches and
dropout seeds) from the seed's weights, judged against the fp32 reference
(``drivers.train.judge``) after running

- the reference in TF32 (the control);
- the reference on the first half of each batch's rows, the mean taken
  over them (a fault).

A step that returns its state unchanged reads 1 (no change against the
reference's) and needs no run.

    python -m port_bench.controls.train --workload <cell> --seeds <n> ...
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from port_bench import harness
from port_bench.drivers import train as T
from port_bench.reference.train import fold_seed


def checked_record(cell, seed: int, device) -> tuple:
    """The cell's structures, weights and its checked steps as ``drivers.train``
    records them (the pairs of each batch, dropout seeds), made without the
    program's step."""
    ds, model, w0, cfg = T.setup_data(cell, seed, device)
    del model
    stream = T.Stream(ds, cell.traffic, harness.Spans(False))
    rng, bs = fold_seed(seed, 3), cell.traffic["batch_size"]
    record = []
    for k, _ in zip(range(cell.traffic["checked_steps"]), stream.warmup()):
        record.append(dict(pairs=ds.log[k * bs:(k + 1) * bs], seed=fold_seed(fold_seed(rng, k), k)))
    return cfg, w0, ds.structures, record


def readings(cell, seed: int, device) -> dict:
    cfg, w0, structures, record = checked_record(cell, seed, device)
    tr = cell.traffic
    ref = T.reference_run(cfg, tr, w0, structures, record, device)
    out = {"seed": seed}
    for name, kw in (("control_tf32", dict(tf32=True)), ("fault_half_batch", dict(half_batch=True))):
        out[name] = T.judge(T.reference_run(cfg, tr, w0, structures, record, device, **kw), ref)
    out["fault_state_unchanged"] = {"change_gap": 1.0}
    return out


def main(argv=None) -> int:
    harness.set_cache_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    harness.require_cuda(cell.chips)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda:0"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
