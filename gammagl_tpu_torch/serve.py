"""Serving: a model placed on its device and warmed up once, or
exported to a file that runs without the model's code.

Counterpart of `gammagl_tpu/serve.py`. The JAX session compiles the
forward ahead of time; here construction moves the model to the device
and runs one warm-up call, which builds the kernels and places each
plan's arrays on the device, so the first request runs at steady-state
cost.

    sess = InferenceSession(model, (x, edge_index), device="cuda",
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    logits = sess(x, edge_index)

`export_forward` traces the same forward with `torch.export`: the
parameters and the plans' arrays go into the artifact, and every kernel
is recorded as its ``torch.library`` op (``gammagl::spmm_csr``,
``gammagl::flash_forward``, ``gammagl::segment_extreme``,
``gammagl::hgt_forward``, ``gammagl::spmm_block_pair``, ...), so the
reloaded program runs the hand-written kernels. The artifact is traced
for one device and one set of shapes; reloading imports the ops and not
the model's code:

    ep = export_forward(model, (x, edge_index), device="cuda",
                        compute_dtype=torch.bfloat16, plan=plan)
    save_exported(ep, "gcn.pt2")          # ship this file
    logits = load_exported("gcn.pt2")(x, edge_index)

`ShardedInferenceSession` serves from a process group: inputs given as
row blocks (JAX's ``P("dp")``) are gathered, the model runs once, and
each process returns its block of the output rows:

    sess = ShardedInferenceSession(model, (x, edge_index),
                                   in_specs=("dp", None), out_specs="dp",
                                   plan=graph.csr_plan())
    logits_blk = sess(x_blk, edge_index)   # this process's rows

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
import re
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["export_forward", "save_exported", "load_exported",
           "InferenceSession", "ShardedInferenceSession", "MicroBatcher"]


def _as_tensor(a, device):
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(np.asarray(a))
    return a.to(device)


def _key_name(key):
    """A dict key as part of a buffer name: an edge type's tuple joined by
    ``__``, anything else but letters, digits and ``_`` made ``_``."""
    if isinstance(key, tuple):
        key = "__".join(str(k) for k in key)
    return re.sub(r"\W", "_", str(key))


def _plans_in(value, name):
    """(buffer-name prefix, plan) for each plan a forward keyword holds: a
    `CSRPlan` or a `BlockPairPlan`, both parts of a `HybridPlan`
    (``_bp``, ``_csr``), and those among a dict's values (a hetero
    model's ``plan_dict``, keyed by edge type)."""
    from gammagl_tpu_torch.ops.cuda import BlockPairPlan, CSRPlan, HybridPlan
    if isinstance(value, (CSRPlan, BlockPairPlan)):
        yield name, value
    elif isinstance(value, HybridPlan):
        for part in ("bp", "csr"):
            if getattr(value, part) is not None:
                yield f"{name}_{part}", getattr(value, part)
    elif isinstance(value, dict):
        for key, item in value.items():
            yield from _plans_in(item, f"{name}_{_key_name(key)}")


class _Exported(torch.nn.Module):
    """The model with its forward keywords bound: each plan among them
    (`_plans_in`) has the arrays its ops read as buffers of this module,
    so the exported program carries them, and the trace reads them in
    place of the plan's own copies (`bind_plan_arrays`). Float inputs
    (the leaves of dict, tuple and list inputs too) are cast to
    ``compute_dtype`` first, as `InferenceSession` casts them."""

    def __init__(self, model, device, compute_dtype, forward_kwargs):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype
        self.forward_kwargs = forward_kwargs
        self._plans = []
        for key, value in forward_kwargs.items():
            for prefix, plan in _plans_in(value, key):
                names = {}
                for name, t in plan.buffers(device).items():
                    names[name] = f"{prefix}_{name}"
                    self.register_buffer(names[name], t.clone())
                self._plans.append((plan, names))

    def forward(self, *inputs):
        from gammagl_tpu_torch.ops.cuda.segment_matmul import (
            bind_plan_arrays)
        if self.compute_dtype is not None:
            inputs = _tree_map(lambda a: a.to(self.compute_dtype)
                               if a.is_floating_point() else a, inputs)
        bound = {plan: {name: getattr(self, buf)
                        for name, buf in names.items()}
                 for plan, names in self._plans}
        with bind_plan_arrays(bound):
            return self.model(*inputs, **self.forward_kwargs)


def export_forward(model, example_inputs, device=None, compute_dtype=None,
                   **forward_kwargs):
    """`torch.export` of ``model(*inputs, **forward_kwargs)`` in eval mode
    on ``device`` (None: the current CUDA card; ``"cpu"`` for the plain
    versions), with float inputs cast to ``compute_dtype``. An input may
    be a tensor (or array) or a dict, tuple or list of them (a hetero
    model's ``x_dict``). The parameters live in the model; the plans among
    the keywords (a `CSRPlan`, `BlockPairPlan` or `HybridPlan`, or a dict
    of them) have their arrays carried as buffers. Returns the
    ``ExportedProgram``, traced for ``device`` and the example inputs'
    shapes and dtypes (JAX's ``platforms`` has no counterpart: one
    artifact, one device).

    Every kernel is recorded as its op (``gammagl::spmm_csr``,
    ``gammagl::flash_forward``, ``gammagl::segment_extreme``,
    ``gammagl::hgt_forward``, ``gammagl::spmm_block_pair``, ...), so the
    program runs the kernels from a file and holds none of their plain
    versions."""
    device = resolve_device(device)
    model = model.to(device).eval()
    wrapper = _Exported(model, device, compute_dtype, forward_kwargs)
    inputs = tuple(_tree_map(lambda a: _as_tensor(a, device), a)
                   for a in example_inputs)
    with torch.no_grad():
        if any(isinstance(p, torch.nn.parameter.UninitializedParameter)
               for p in model.parameters()):
            wrapper(*inputs)  # lazy layers take their sizes, as flax's init
        return torch.export.export(wrapper, inputs)


def save_exported(exported, path):
    """Write an ``ExportedProgram`` (`export_forward`) to ``path``:
    the program, its parameters and buffers, without the example inputs
    it was traced with (a graph's whole feature table)."""
    example = exported.example_inputs
    exported.example_inputs = None
    try:
        torch.export.save(exported, path)
    finally:
        exported.example_inputs = example


def load_exported(path):
    """Reload an artifact of `save_exported`. The port's ops are
    registered first (importing no model code); returns the program as a
    callable module, its parameters frozen for serving:
    ``load_exported(path)(x, edge_index)`` runs it on the device it was
    traced for."""
    import gammagl_tpu_torch.ops.cuda  # noqa: F401 (registers every op)
    ep = torch.export.load(path)
    for entry in ep.module_call_graph:
        sig = entry.signature
        if sig is not None:
            sig.in_spec = _tuple_keys(sig.in_spec)
            sig.out_spec = _tuple_keys(sig.out_spec)
    return ep.module().requires_grad_(False)


def _tuple_keys(spec):
    """``spec`` with the dict keys that a saved program holds as lists (the
    file's JSON has no tuples: a hetero model's edge types) made tuples
    again; a list is never a dict key, so every such list was a tuple."""
    if spec.is_leaf():
        return spec
    kids = (spec.children() if callable(getattr(spec, "children", None))
            else spec.children_specs)
    context = spec.context
    if spec.type is dict:
        context = [_as_tuple(k) if isinstance(k, list) else k
                   for k in context]
    return pytree.TreeSpec(spec.type, context,
                           [_tuple_keys(kid) for kid in kids])


def _as_tuple(key):
    return tuple(_as_tuple(k) if isinstance(k, list) else k for k in key)


class InferenceSession:
    """Eval-mode forward of ``model`` on ``device`` (None: the current
    CUDA card; raises when torch sees none, so ask for ``"cpu"`` to run
    the plain versions on the host).

    Each call moves its inputs to the device (numpy arrays become
    tensors; a dict, tuple or list input leaf by leaf), casts float inputs
    to ``compute_dtype`` when one is given,
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

    def _place_raw(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))
        return a.to(self.device)

    def _place(self, a):
        """An input on the device, cast; a dict, tuple or list input
        (a hetero model's ``x_dict``) leaf by leaf."""
        return _tree_map(self._place_leaf, a)

    def _place_leaf(self, a):
        a = self._place_raw(a)
        if self.compute_dtype is not None and a.is_floating_point():
            a = a.to(self.compute_dtype)
        return a

    def __call__(self, *inputs):
        with torch.inference_mode():
            return self.model(*(self._place(a) for a in inputs),
                              **self.forward_kwargs)


def _row_spec(spec):
    """True for a spec that cuts rows over the group (an axis name such as
    ``"dp"``, or a tuple whose first entry is one), False for a
    replicated one (None or ``()``)."""
    if spec is None or spec == ():
        return False
    if isinstance(spec, str):
        return True
    spec = tuple(spec)
    if spec[0] is not None and all(s is None for s in spec[1:]):
        return True
    raise NotImplementedError(f"spec {spec!r}: only row blocks (an axis "
                              "first) or replicated inputs are served")


class ShardedInferenceSession(InferenceSession):
    """Serving from a process group, counterpart of the JAX package's
    pjit session over a mesh.

    JAX hands any ``apply_fn`` to GSPMD, which partitions it; the port
    cannot partition an arbitrary model, so the session computes the same
    function at its surface (ROADMAP C59): an input whose spec cuts rows
    (``"dp"``, JAX's ``P("dp")``) may be given as this process's block of
    rows, which is gathered from the group (``all_gather``, rows by owner,
    so every bit comes back), or whole; a replicated input (None, JAX's
    ``P()``) is given whole. The model then runs once, as in
    `InferenceSession`, on ``device`` (None: the card), with float inputs
    cast to ``compute_dtype``, and each process returns the rows of the
    output that ``out_specs`` gives it: None the whole output, a spec its
    block; for a tuple output one spec for all, or a list of one spec an
    output.

    The block rule is JAX's for ``P("dp")``: rows in P contiguous blocks
    of N / P, process r the r-th; an N that P does not divide raises
    ValueError, as JAX's sharding does, at construction for the example
    inputs and the output. Every process calls with the same forms (a
    gather is a collective). ``example_inputs`` are whole. ``export()``
    gives `export_forward`'s artifact of the forward (one device, the
    whole inputs)."""

    def __init__(self, model, example_inputs, in_specs, out_specs=None,
                 group=None, device=None, compute_dtype=None,
                 **forward_kwargs):
        # here, not at import: `load_exported` in a fresh process imports
        # this module, and the parallel package would pull in its tiers
        from gammagl_tpu_torch.parallel.mesh import world
        self.rank, self.size, self.group = world(group)
        self._example = tuple(example_inputs)
        in_specs = tuple(in_specs)
        if len(in_specs) != len(self._example):
            raise ValueError("in_specs must match example_inputs")
        self._rows = tuple(_row_spec(s) for s in in_specs)
        self._n = tuple(int(np.shape(a)[0]) if rows else None
                        for a, rows in zip(self._example, self._rows))
        for n in self._n:
            self._check_rows(n)
        self.out_specs = out_specs
        super().__init__(model, self._example, device, compute_dtype,
                         **forward_kwargs)

    def _check_rows(self, n):
        if n is not None and n % self.size:
            raise ValueError(f"{n} rows cannot be cut into {self.size} "
                             "equal row blocks (JAX's P('dp') needs the "
                             "dimension divisible by the axis size)")

    def _block(self, a):
        b = a.shape[0] // self.size
        return a[self.rank * b:(self.rank + 1) * b]

    def _whole(self, a, n):
        """Input ``a`` whole: as given, or gathered from its row blocks."""
        if a.shape[0] == n:
            return a
        if a.shape[0] * self.size != n:
            raise ValueError(f"an input of {a.shape[0]} rows is neither the "
                             f"whole ({n}) nor this process's block "
                             f"({n // self.size})")
        parts = [torch.empty_like(a) for _ in range(self.size)]
        dist.all_gather(parts, a.contiguous(), group=self.group)
        return torch.cat(parts)

    def _cut(self, out, spec):
        if not _row_spec(spec):
            return out
        self._check_rows(out.shape[0])
        return self._block(out).clone()

    def device_put(self, *inputs):
        """This process's share of the inputs on the device: its block of
        each row-cut input (given whole or as the block), each replicated
        input whole (no cast)."""
        out = []
        for a, rows, n in zip(inputs, self._rows, self._n):
            a = self._place_raw(a)
            out.append(self._block(a) if rows and a.shape[0] == n else a)
        return tuple(out)

    def __call__(self, *inputs):
        whole = tuple(self._whole(self._place_raw(a), n) if rows
                      else a for a, rows, n in zip(inputs, self._rows,
                                                   self._n))
        out = super().__call__(*whole)
        spec = self.out_specs
        if isinstance(out, (tuple, list)):
            specs = spec if isinstance(spec, list) else [spec] * len(out)
            return type(out)(self._cut(o, s) for o, s in zip(out, specs))
        return self._cut(out, spec)

    def export(self):
        """`export_forward` of the model's forward on the whole example
        inputs, on this session's device and compute dtype."""
        return export_forward(self.model, self._example, device=self.device,
                              compute_dtype=self.compute_dtype,
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
