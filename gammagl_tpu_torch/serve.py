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

On a graph with locality, relabel the nodes once and let the graph pick
its plan: the block-pair kernel when the (dst block, src block) tiling is
dense, a hybrid of it and the CSR kernel when part of it is:

    g2, perm = graph.reorder_rcm()          # g2.x == graph.x[perm]
    sess = InferenceSession(model, (g2.x, g2.edge_index), device="cuda",
                            compute_dtype=torch.bfloat16,
                            plan=g2.auto_plan())
"""

import numpy as np
import torch

from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["InferenceSession"]


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
