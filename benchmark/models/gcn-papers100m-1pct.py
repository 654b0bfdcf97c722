"""The system under test for gcn-papers100m-1pct: the port's full-graph
GCN trainer, `parallel.make_partitioned_gcn_train_staged`, on a one-part
`build_halo_partition_planned` with `auto_src_blocks` source blocks, as
the port's papers100M example builds it.

The benchmark makes the graph, the step masks and the weights from the
seed on the device; the port gets the graph as host arrays (its
partition is built there), its GCN norms from its own
`calc_gcn_norm_np`, and the weights copied into the parameters that
`make_partitioned_gcn_train_staged` made.
"""

import numpy as np
import torch

from graphs.papers import papers_graph, step_masks


def _dims(cfg):
    return ([cfg["feat_dim"]] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1)
            + [cfg["num_classes"]])


def make_inputs(cfg, seed, device):
    """What both sides are handed: the graph, features, labels, the step
    masks and the initial weights, all from ``seed``."""
    g = cfg["graph"]
    src, dst, x, y = papers_graph(g["scale"], g["graph_seed"], seed, device,
                                  homophily=g["homophily"],
                                  zipf_a=g["zipf_a"],
                                  feat_dim=cfg["feat_dim"],
                                  num_classes=cfg["num_classes"])
    n = x.shape[0]
    masks = step_masks(n, cfg["step_masks"], cfg["train_share"], seed,
                       device)
    dims = _dims(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    sizes = [dims[i] * dims[i + 1] for i in range(len(dims) - 1)]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    weights, off = {}, 0
    for i, size in enumerate(sizes):
        lim = (6.0 / (dims[i] + dims[i + 1])) ** 0.5
        weights[f"w{i}"] = (u[off:off + size] * lim).view(dims[i],
                                                          dims[i + 1])
        weights[f"b{i}"] = torch.zeros(dims[i + 1], device=device)
        off += size
    return {"src": src, "dst": dst, "x": x, "y": y, "masks": masks,
            "weights": weights,
            "checksum": (int(src.sum()), int(dst.sum()), int(y.sum()))}


def work(cfg, n, e):
    """One training step's aggregations and dense products, counted from
    the model's shapes (see harness/work.py): three forward aggregations,
    two on the transpose for dx (the first layer's input needs none), and
    per layer the forward product, dW, and dx where it flows on."""
    dims = _dims(cfg)
    L, dt = cfg["num_layers"], cfg["compute_dtype"]
    item = {"bfloat16": 2, "float32": 4}[dt]
    spmm = [{"rows": n, "cols": n, "edges": e, "width": dims[i],
             "itemsize": item, "dtype": dt} for i in range(L)]
    spmm += [{"rows": n, "cols": n, "edges": e, "width": dims[i],
              "itemsize": item, "dtype": dt} for i in range(1, L)]
    mm = []
    for i in range(L):
        mm.append({"m": n, "k": dims[i], "n": dims[i + 1], "dtype": dt})
        mm.append({"m": dims[i], "k": n, "n": dims[i + 1], "dtype": dt})
        if i:
            mm.append({"m": n, "k": dims[i + 1], "n": dims[i], "dtype": dt})
    return {"spmm": spmm, "matmul": mm}


class System:
    """The trainer built from ``inputs``: ``step(i)`` is the window's call
    (one optimizer step on step mask i mod the masks)."""

    def __init__(self, cfg, inputs, device, phases):
        from gammagl_tpu_torch.parallel import (
            auto_src_blocks, build_halo_partition_planned,
            make_partitioned_gcn_train_staged, shard_nodes)
        from gammagl_tpu_torch.utils import calc_gcn_norm_np

        cd = getattr(torch, cfg["compute_dtype"])
        x, n = inputs["x"], inputs["x"].shape[0]
        loops = torch.arange(n, device=x.device)
        ei = torch.stack([torch.cat([inputs["src"], loops]),
                          torch.cat([inputs["dst"], loops])]).cpu().numpy()
        w = calc_gcn_norm_np(ei, n)
        nsb = auto_src_blocks(n, max(cfg["feat_dim"], cfg["hidden_dim"]), cd)
        part = build_halo_partition_planned(ei, n, 1, w, num_src_blocks=nsb)
        del ei, w
        phases.mark(f"plan (planned partition, {nsb} source blocks, "
                    f"{len(part.interior)} interior plans, transpose "
                    f"{len(part.transpose.interior)})")
        self.xs = shard_nodes(x.cpu().numpy(), part, device=device, dtype=cd)
        self.ys = shard_nodes(inputs["y"].cpu().numpy(), part, device=device)
        self.ms = [shard_nodes(m.cpu().numpy().astype(np.float32), part,
                               device=device) for m in inputs["masks"]]
        phases.mark("transfer (features, labels, masks: `shard_nodes`)")
        self.params, self.opt, self._step, _ = \
            make_partitioned_gcn_train_staged(
                part, cfg["feat_dim"], cfg["hidden_dim"], cfg["num_classes"],
                num_layers=cfg["num_layers"], compute_dtype=cd,
                learning_rate=cfg["learning_rate"],
                weight_decay=cfg["weight_decay"], device=device)
        with torch.no_grad():
            for k, t in self.params.items():
                t.copy_(inputs["weights"][k])
        self.beta1 = self.opt.param_groups[0]["betas"][0]
        phases.mark("trainer (`make_partitioned_gcn_train_staged`, the "
                    "weights)")

    def step(self, i):
        self.params, self.opt, loss = self._step(
            self.params, self.opt, self.xs, self.ys, self.ms[i % len(self.ms)])
        return loss

    def first_grads(self):
        """Each leaf's gradient as the optimizer took it in the first step,
        from its first moment: m1 = (1 - beta1) g."""
        return {k: self.opt.state[t]["exp_avg"].detach().clone()
                / (1 - self.beta1) for k, t in self.params.items()}

    def snapshot(self):
        return {k: t.detach().clone() for k, t in self.params.items()}

    def free(self):
        del self.xs, self.ys, self.ms, self.params, self.opt, self._step


def build_trainer(cfg, seed, device, phases):
    inputs = make_inputs(cfg, seed, device)
    n, e = inputs["x"].shape[0], inputs["src"].shape[0] + inputs["x"].shape[0]
    phases.mark(f"graph ({n} nodes, {e} edges with self-loops, on the "
                "device)")
    system = System(cfg, inputs, device, phases)
    system.work = work(cfg, n, e)
    system.init = {k: v.clone() for k, v in inputs["weights"].items()}
    system.checksum = inputs["checksum"]
    return system
