"""What every run of the benchmark shares: finding a cell's files by name,
the cache directories, the device check, the traced window and its
reduction, the per-layer metric readers, the import check and the result
line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
the file its ``configs`` entry gives) and a traffic mix
(``traffic/<name>.json``); the traffic file names its driver
(``drivers/<driver>.py``), each per-layer metric is read by
``metrics/<metric>.py``, and ``limits/<cell>.json`` holds the limit of each
number that ``correct`` compares. Nothing here names a cell, a configuration, a mix
or a metric, so a later change adds them as files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)        # the checkout
CACHE_DIR = os.path.join(PKG_DIR, ".cache")
# top-level modules that must not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "protein_ensemble_vae_tpu")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock, from /proc (the
    import time of this module where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def set_cache_env() -> None:
    """Keep every build and kernel cache at a fixed path inside the
    checkout: the port's nvcc builds (``PEV_COMPILE_CACHE``, which the
    drivers pass to ``utils.compile_cache.enable_compilation_cache``, as
    the CLIs do), Triton's and torch's extension builds."""
    os.environ["PEV_COMPILE_CACHE"] = os.path.join(CACHE_DIR, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


@dataclasses.dataclass
class Cell:
    """One cell and what its files hold."""

    name: str
    chips: int
    config: dict              # configs/<name>.json
    traffic: dict             # traffic/<name>.json
    end_to_end: list          # BENCHMARK.json metrics this cell reports
    per_layer: list
    limits: dict              # limits/<cell>.json: each compared number's limit


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "port_bench", "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    with open(os.path.join(root, "port_bench", "limits", name + ".json")) as f:
        limits = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, limits=limits)


def driver(traffic: dict):
    """The module ``drivers/<traffic["driver"]>.py``."""
    return importlib.import_module(f"port_bench.drivers.{traffic['driver']}")


def reader(root: str, metric: str) -> Callable:
    """``read(records) -> value or None`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, "port_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cuda(chips: int) -> None:
    """Exit (no result) unless ``chips`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the port on the GPU only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Host spans and the traced window
# ---------------------------------------------------------------------------

class Spans:
    """Host spans of the benchmark's own calls into the program's layers:
    ``(name, start, end)`` on ``time.perf_counter``; under a trace each is
    also a profiler annotation, which places it on the trace's clock."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.items: list = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed

    def span(self, name: str):
        return _Span(self, name)

    def seconds(self, name: str) -> list:
        return [b - a for n, a, b in self.items if n == name]


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        if self.spans.traced:
            import torch

            self.rf = torch.profiler.record_function("bench::" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.items.append((self.name, self.t0, time.perf_counter()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def profiler(traced: bool):
    """A ``torch.profiler.profile`` of host annotations and device
    activity, or a context that does nothing. Its events are read raw
    (``reduce_trace``); the profiler's own parse into a tree of function
    events, slow for millions of events, is switched off where the
    installed torch parses on exit."""
    import contextlib

    if not traced:
        return contextlib.nullcontext(None)
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return _Unparsed(activities=acts)


class _Unparsed:
    """``torch.profiler.profile`` whose inner profiler keeps its raw
    results and builds no function events."""

    def __init__(self, **kwargs):
        from torch.profiler import profile

        self.prof = profile(**kwargs)

    def __enter__(self):
        self.prof.__enter__()
        inner = getattr(self.prof, "profiler", None)
        if inner is not None and hasattr(inner, "_parse_kineto_results"):
            inner._parse_kineto_results = lambda *a, **k: []
        return self.prof

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)


def _raw_events(prof) -> list:
    """(name, is_device, start_us, end_us) of every event of the trace."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
            out.append((e.name(), e.device_type() == cuda, start, start + dur))
        return out
    import torch

    for e in prof.events() or ():
        out.append((e.name, e.device_type == torch.autograd.DeviceType.CUDA,
                    e.time_range.start, e.time_range.end))
    return out


def reduce_trace(prof) -> dict:
    """The traced window's records: the window (the span of the
    ``bench::window`` annotation), the union of device intervals inside it
    (``busy_s``), device seconds by kernel name, the benchmark's host spans
    on the trace's clock, and the idle gaps between device intervals, each
    put to the host span that covers its middle."""
    events = _raw_events(prof)
    win = [(a, b) for n, dev, a, b in events if not dev and n == "bench::window"]
    if not win:
        raise RuntimeError("the trace holds no bench::window annotation")
    w0, w1 = win[0]
    spans = sorted((n[len("bench::"):], a, b) for n, dev, a, b in events
                   if not dev and n.startswith("bench::") and n != "bench::window")
    # the device-side copies of host annotations (user annotations mirrored
    # onto the GPU timeline) span kernels, and are no device work
    host_names = {n for n, d, _, _ in events if not d}
    dev = sorted((max(a, w0), min(b, w1), n) for n, d, a, b in events
                 if d and n not in host_names and not n.startswith(("ProfilerStep", "bench::"))
                 and b > w0 and a < w1)
    busy, end, gaps = 0.0, w0, []
    by_kernel: dict = {}
    for a, b, n in dev:
        by_kernel[n] = by_kernel.get(n, 0.0) + (b - a) / 1e6
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    idle: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # the innermost (latest-starting) span that covers the gap's middle
        owner = "other"
        for n, s0, s1 in spans:
            if s0 <= mid <= s1:
                owner = n
        idle[owner] = idle.get(owner, 0.0) + (b - a) / 1e6
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, device_events=len(dev),
                kernel_s=by_kernel, idle_s=idle)


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the ten host
    spans under which the device idled longest, in seconds."""
    ops = sorted(trace["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def device_info(count: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak)}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown_: Optional[dict] = None) -> str:
    """The last line of standard output; ``checks`` come last, under
    ``checks``, each number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)
