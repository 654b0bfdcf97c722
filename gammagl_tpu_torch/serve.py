"""Serving: a model placed on its device and warmed up once.

Counterpart of `InferenceSession` in `gammagl_tpu/serve.py`. The JAX
session compiles the forward ahead of time; here construction moves the
model to the device and runs one warm-up call, which builds the kernels
and places each plan's arrays on the device, so the first request runs at
steady-state cost.

    sess = InferenceSession(model, (x, edge_index), device="cuda",
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    logits = sess(x, edge_index)

`MicroBatcher` batches concurrent single requests: a worker thread stacks
what is queued, pads it to a bucket and calls a function of the batch,
typically one of an `InferenceSession` a bucket:

    mb = MicroBatcher(run, buckets=(8, 32), linger_ms=3.0)
    logits = mb.submit(np.asarray([seed])).result()

On a graph with locality, relabel the nodes once and let the graph pick
its plan: the block-pair kernel when the (dst block, src block) tiling is
dense, a hybrid of it and the CSR kernel when part of it is:

    g2, perm = graph.reorder_rcm()          # g2.x == graph.x[perm]
    sess = InferenceSession(model, (g2.x, g2.edge_index), device="cuda",
                            compute_dtype=torch.bfloat16,
                            plan=g2.auto_plan())
"""

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch

from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["InferenceSession", "MicroBatcher"]


class InferenceSession:
    """Eval-mode forward of ``model`` on ``device`` (None: the current
    CUDA card; raises when torch sees none, so ask for ``"cpu"`` to run
    the plain versions on the host).

    Each call moves its inputs to the device (numpy arrays become
    tensors), casts float inputs to ``compute_dtype`` when one is given,
    and runs ``model(*inputs, **forward_kwargs)`` under
    ``torch.inference_mode()``. The output is returned as the model
    produces it (float32 logits for `GCNModel`).
    """

    def __init__(self, model, example_inputs, device=None, compute_dtype=None,
                 **forward_kwargs):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = model.to(self.device).eval()
        self.forward_kwargs = forward_kwargs
        self(*example_inputs)

    def _place(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))
        a = a.to(self.device)
        if self.compute_dtype is not None and a.is_floating_point():
            a = a.to(self.compute_dtype)
        return a

    def __call__(self, *inputs):
        with torch.inference_mode():
            return self.model(*(self._place(a) for a in inputs),
                              **self.forward_kwargs)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (tuples, named
    ones too, lists and dicts; anything else is a leaf)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        vals = [_tree_map(fn, *parts) for parts in zip(*trees)]
        if hasattr(first, "_fields"):
            return type(first)(*vals)
        return type(first)(vals)
    return fn(*trees)


def _host(a):
    """A tensor as a numpy array on the host (bf16 widened to float32,
    which numpy lacks; exact); anything else through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class MicroBatcher:
    """Request-batching queue: concurrent single requests ride one padded
    batch (counterpart of `gammagl_tpu/serve.py`'s; the reference serves
    nothing).

    Submitted items are trees (arrays, or tuples, lists and dicts of
    them) whose leaves stack along a new leading axis. A worker thread
    drains the queue, pads the stack with zeros to the smallest bucket of
    ``buckets`` that holds it, and calls ``run_fn(batch, n_valid)``,
    typically a closure over an `InferenceSession` a bucket. Its output
    (leading axis = the bucket) is moved to the host once and split back
    to each request's future; an exception in ``run_fn`` is set on every
    future of the batch.

    ``linger_ms``: how long the worker waits after the first pending
    request before it runs a partial batch; a full batch of the largest
    bucket runs at once.
    """

    def __init__(self, run_fn: Callable, buckets: Sequence[int],
                 linger_ms: float = 2.0, max_queue: int = 4096):
        self.run_fn = run_fn
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.linger_s = float(linger_ms) / 1e3
        self._q = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> Future:
        fut = Future()
        self._q.put((item, fut))
        return fut

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _take_batch(self):
        cap = self.buckets[-1]
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.linger_s
        while len(batch) < cap:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            items, futs = zip(*batch)
            n = len(items)
            bucket = next(b for b in self.buckets if b >= n)
            try:
                # batching is host numpy: one copy to the device a batch
                def _stack(*leaves):
                    arr = np.stack([_host(leaf) for leaf in leaves])
                    if bucket > n:
                        pad = np.zeros((bucket - n,) + arr.shape[1:],
                                       arr.dtype)
                        arr = np.concatenate([arr, pad], axis=0)
                    return arr

                stacked = _tree_map(_stack, *items)
                out = _tree_map(_host, self.run_fn(stacked, n))  # one fetch
                rows = [_tree_map(lambda a, i=i: a[i], out)
                        for i in range(n)]
                for fut, row in zip(futs, rows):
                    fut.set_result(row)
            except Exception as e:  # every waiter of the batch gets it
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
