"""One run of one cell of ``BENCHMARK.json``.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell from its files (configuration, traffic, driver), warms
up every shape its traffic uses, measures one window of ``--seconds``,
checks what the window produced against the plain reference, and prints
one JSON line last on standard output. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
window. It refuses to run without the CUDA devices the cell asks for and
exits non-zero, with no result, when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import sys
import time

from port_bench import harness

def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device=None, root: str = harness.ROOT) -> tuple:
    """Run the cell; returns (result line, lines for standard error).
    ``device`` other than None skips the look for CUDA devices (tests)."""
    started = harness.process_start()
    cell = harness.load_cell(root, args.workload)
    import torch

    if device is None:
        harness.require_cuda(cell.chips)
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(4)
    spans = harness.Spans(traced=bool(args.trace))
    out = harness.driver(cell.traffic).run(cell, args, device, spans,
                                           harness.profiler(bool(args.trace)))
    setup_s = out["t0"] - (started - time.time() + time.perf_counter())
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"modules that the port must not load were loaded: {found}")
    if args.trace:
        records = dict(out["records"], setup_s=setup_s)
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(root, m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = out["checks"]
    correct = out["failed"] == 0 and all(c.ok for c in checks)
    dev = (harness.device_info(cell.chips, out["memory_peak"]) if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    trace = out["records"].get("trace")
    if args.trace and trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    line = harness.result_line(correct, out["attempted"], out["failed"], metrics, dev, checks,
                               harness.breakdown(trace) if args.trace and trace else None)
    notes = out.get("notes", []) + [
        f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}"
        for c in checks]
    return line, notes


def main(argv=None) -> int:
    harness.set_cache_env()
    args = parse(argv)
    line, notes = execute(args)
    print(line, flush=True)
    for n in notes:
        print(n, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
