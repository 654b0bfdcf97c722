"""Double-buffered host -> device prefetch (counterpart of
`gammagl_tpu/loader/prefetch.py`).

A background thread runs the host sampler and collation and moves the
next batch to the card while the current step computes. On a card the
worker copies from pinned memory on a side stream; the consumer's
stream waits on an event recorded after each batch's copies, and every
tensor that crosses streams is marked with ``record_stream``, so the
caching allocator keeps it until the consumer's work on it is done.
"""

import queue
import threading

import numpy as np
import torch

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["PrefetchLoader", "prefetch_to_device", "pipeline"]


def pipeline(iterator, size=2, transform=None):
    """Run ``iterator`` in a background thread, ``size`` items ahead.

    ``transform`` (run in the worker thread) defaults to the identity:
    use it for host work to take off the consumer's critical path. An
    exception in the worker is raised in the consumer, after the items
    produced before it."""
    q = queue.Queue(maxsize=size)
    sentinel = object()
    err = []

    def worker():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                q.put(item)
        except Exception as e:  # surfaced in the consumer thread
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def _move(item, device, pin, moved):
    """``item`` with every array a tensor on ``device``: Graphs (a copy,
    as `Graph.tensor`), tuples (named ones too), lists and dicts are
    walked; other values are kept. Host tensors are copied through pinned
    memory without blocking when ``pin``; each tensor made is appended to
    ``moved``."""
    if isinstance(item, Graph):
        g = item.clone()
        for k, v in g.items():
            g[k] = _move(v, device, pin, moved)
        return g
    if isinstance(item, tuple):
        vals = [_move(v, device, pin, moved) for v in item]
        return type(item)(*vals) if hasattr(item, "_fields") else tuple(vals)
    if isinstance(item, list):
        return [_move(v, device, pin, moved) for v in item]
    if isinstance(item, dict):
        return {k: _move(v, device, pin, moved) for k, v in item.items()}
    if isinstance(item, np.ndarray):
        arr = np.ascontiguousarray(item)
        item = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if not isinstance(item, torch.Tensor):
        return item
    if item.device == device:
        return item
    if pin and item.device.type == "cpu":
        item = item.pin_memory()
    out = item.to(device, non_blocking=pin)
    moved.append(out)
    return out


def prefetch_to_device(iterator, size=2, device=None):
    """Generator over ``iterator``'s items moved to ``device`` (None: the
    card), ``size`` batches ahead of the consumer."""
    device = resolve_device(device)
    if device.type != "cuda":
        return pipeline(iterator, size,
                        transform=lambda item: _move(item, device, False, []))
    return _prefetch_cuda(iterator, size, device)


def _prefetch_cuda(iterator, size, device):
    stream = torch.cuda.Stream(device)

    def transform(item):
        moved = []
        with torch.cuda.stream(stream):
            out = _move(item, device, True, moved)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, moved, ready

    for out, moved, ready in pipeline(iterator, size, transform):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in moved:
            t.record_stream(consumer)
        yield out


class PrefetchLoader:
    """Any host loader, its batches moved to ``device`` (None: the card)
    ``size`` batches ahead."""

    def __init__(self, loader, size=2, device=None):
        self.loader = loader
        self.size = size
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return prefetch_to_device(iter(self.loader), self.size, self.device)
