"""Host-to-device prefetch with double buffering (counterpart of the JAX
package's ``data/prefetch.py:prefetch_to_device``).

The collate path makes numpy batches on the host. For a CUDA device each
batch is copied from pinned host memory with ``non_blocking`` copies issued
on a side stream, ``size`` batches ahead, so the copy of batch N+1 overlaps
the compute of batch N. Before a batch is handed out, the compute stream
waits on the event recorded after its copies, and every copied tensor is
marked with ``record_stream`` for the compute stream, so the allocator does
not hand its memory to the side stream's next copy while the compute stream
may still read it (the pinned host buffers are held by the caching host
allocator until their copies have finished).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prefetch_to_device(iterator: Iterable, device, size: int = 2) -> Iterator:
    """Yield the items of ``iterator`` (nested dicts of numpy arrays) as
    tensors on ``device``, with ``size`` of them already in flight."""
    device = torch.device(device)
    if device.type != "cuda":
        for item in iterator:
            yield _tree_map(lambda a: torch.as_tensor(np.asarray(a), device=device), item)
        return

    copy_stream = torch.cuda.Stream(device)

    def put(item):
        with torch.cuda.stream(copy_stream):
            out = _tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                .to(device, non_blocking=True), item)
        done = torch.cuda.Event()
        done.record(copy_stream)
        return out, done

    queue = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append(put(item))
        if len(queue) >= size:
            break
    while queue:
        out, done = queue.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in _leaves(out):
            t.record_stream(compute)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield out
