#!/usr/bin/env python3
"""Find which stage of ieHGCN's float32 forward parts it from float64 on
chip_smoke.py phase 32's typed graph, and print one JSON line.

    python3 scripts/iehgcn_precision.py [--seeds N] [--small] [--device D]

The graph is chip_smoke.py's `hgt_graph` (100,000 papers, 200,000
authors, 5,000,000 edges; ``--small`` cuts it to a tenth of the nodes
and a hundredth of the edges, for a check on the CPU). For each of N init
seeds (the first is phase 32's, SEED + 32) an `ieHGCNModel` is made as
phase 32 makes it (hidden 16, 349 classes, 2 layers), and its forward is
run again here stage by stage, each stage in float32 or float64:

    proj  the type projections and their ReLU
    lin   each conv's self and relation maps
    mean  the means over each destination's edges (`segment_mean`)
    attn  the queries, keys, scores, softmax over the candidates, blend
    head  the class map

For each variant, the error of each of phase 32's four requests (the
paper features + r * 1e-3) is max |out - out64| / max |out64| against
the model's own float64 forward, and the variant's reading is the largest
of the four. The variants: every stage in float32 (held to the model's
own float32 forward at 1e-4 of max |out|: on a card two float32 runs
differ by the order of the means' atomic adds), every stage in float64
(held to the model's float64 forward at 1e-12), each stage alone in
float32 with the rest in float64, each stage alone in float64 with the
rest in float32, and two lower precision controls: the model's own
forward with TF32 matmuls (on a card) and in bfloat16. Beside them: the
model's own float32 forward run twice (on a card the means' atomic adds
change their order), and for each seed and layer of the target type the
largest |score| and the share of nodes whose softmax over the candidates
is not one-hot (top weight below 0.99), where an error in a score moves
the output. Imports no JAX; runs on the card unless ``--device cpu``.
"""

import argparse
import copy
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gammagl_tpu_torch.layers.conv.hetero_conv import _name  # noqa: E402
from gammagl_tpu_torch.ops import segment_mean  # noqa: E402

STAGES = ("proj", "lin", "mean", "attn", "head")
N_REQUESTS = 4


def staged_forward(model, x_dict, ei_dict, prec, stats=None):
    """ieHGCNModel's forward with stage s in dtype ``prec[s]``: a stage
    casts its inputs and parameters to its dtype. ``stats``, a list,
    gains (max |score|, the share of rows not one-hot) of each layer's
    target type."""
    def lin(layer, x, stage):
        dt = prec[stage]
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    h = {nt: F.relu(lin(model.proj[nt], x, "proj"))
         for nt, x in x_dict.items()}
    for conv in model.convs:
        self_h = {nt: lin(conv.w_self[nt], v, "lin") for nt, v in h.items()}
        agg = {nt: [] for nt in h}
        for et in conv.edge_types:
            src_t, _, dst_t = et
            ei = ei_dict[et]
            msg = lin(conv.w[_name(et)], h[src_t], "lin")[ei[0]]
            agg[dst_t].append(segment_mean(msg.to(prec["mean"]), ei[1],
                                           h[dst_t].shape[0]))
        out = {}
        dt = prec["attn"]
        for nt, parts in agg.items():
            cands = [c.to(dt) for c in [self_h[nt]] + parts]
            q = lin(conv.q[nt], self_h[nt], "attn")
            scores = torch.stack([(q * lin(k, c, "attn")).sum(-1)
                                  for k, c in zip(conv.k[nt], cands)], 0)
            att = torch.softmax(scores, 0)
            if stats is not None and nt == model.target_ntype:
                stats.append((float(scores.abs().max()),
                              float((att.max(0).values < 0.99).double()
                                    .mean())))
            out[nt] = (att[..., None] * torch.stack(cands, 0)).sum(0)
        h = out
    return lin(model.lin, h[model.target_ntype], "head")


def requests(x_dict, target):
    return [{**x_dict, target: x_dict[target] + r * 1e-3}
            for r in range(N_REQUESTS)]


def rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def run_seed(models, hg, seed, dev):
    from gammagl_tpu_torch.examples import common
    x_dict, ei_dict, _, _, _ = common.hetero_tensors(hg, "paper", dev)
    torch.manual_seed(seed)
    model = models.ieHGCNModel(hg.metadata(), cs.WAVE2_HIDDEN,
                               cs.HGT_CLASSES, "paper",
                               in_channels=cs.HGT_FEAT).to(dev).eval()
    model64 = copy.deepcopy(model).double()
    model16 = copy.deepcopy(model).bfloat16()
    f32 = {s: torch.float32 for s in STAGES}
    f64 = {s: torch.float64 for s in STAGES}
    variants = {"float32": f32, "float64": f64}
    for s in STAGES:
        variants[f"only {s} float32"] = {**f64, s: torch.float32}
        variants[f"{s} float64"] = {**f32, s: torch.float64}
    controls = ["tf32 matmuls (model)"] if dev == "cuda" else []
    controls.append("bfloat16 (model)")
    errs = {name: 0.0 for name in [*variants, *controls]}
    stats = []
    checks = {"staged float32 vs model": 0.0, "model float32 run twice": 0.0,
              "staged float64 vs model": 0.0}
    with torch.no_grad():
        for r, inp in enumerate(requests(x_dict, "paper")):
            inp64 = cs.to_double(inp)
            want = model64(inp64, ei_dict)
            own32 = model(inp, ei_dict)
            checks["model float32 run twice"] = max(
                checks["model float32 run twice"],
                rel_err(model(inp, ei_dict), own32.double()))
            for name, prec in variants.items():
                got = staged_forward(model, inp if prec is f32 else inp64,
                                     ei_dict, prec,
                                     stats if name == "float32" and r == 0
                                     else None)
                errs[name] = max(errs[name], rel_err(got, want))
                if name in ("float32", "float64"):
                    key = f"staged {name} vs model"
                    checks[key] = max(checks[key], rel_err(
                        got, own32.double() if name == "float32" else want))
            if dev == "cuda":
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    got = model(inp, ei_dict)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                errs[controls[0]] = max(errs[controls[0]],
                                        rel_err(got, want))
            got16 = model16({nt: v.bfloat16() for nt, v in inp.items()},
                            ei_dict)
            errs["bfloat16 (model)"] = max(errs["bfloat16 (model)"],
                                           rel_err(got16, want))
    if (checks["staged float32 vs model"] > 1e-4
            or checks["staged float64 vs model"] > 1e-12):
        raise SystemExit(f"staged forward is not the model's: {checks}")
    return {"seed": seed, "errs": errs, "checks": checks,
            "layers": [{"max_abs_score": m, "not_one_hot": share}
                       for m, share in stats],
            "max_abs_out64": float(want.abs().max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    if args.small:
        cs.HGT_PAPERS, cs.HGT_AUTHORS = 10_000, 20_000
        cs.HGT_WRITES, cs.HGT_CITES = 20_000, 10_000
    card = None
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0]
        print(card)
    from gammagl_tpu_torch import models
    from gammagl_tpu_torch.data import HeteroGraph
    hg = cs.hgt_graph(HeteroGraph)
    degs = {str(et): int(np.bincount(np.asarray(hg[et].edge_index[1])).max())
            for et in hg.metadata()[1]}
    print(f"largest in-degree a relation: {degs}")
    rows = [run_seed(models, hg, cs.SEED + 32 + s, args.device)
            for s in range(args.seeds)]
    names = list(rows[0]["errs"])
    print(f"{'variant':<22}" + "".join(f"  seed {r['seed']:<6}" for r in rows)
          + "  max")
    for name in names:
        vals = [r["errs"][name] for r in rows]
        print(f"{name:<22}" + "".join(f"  {v:.3e}" for v in vals)
              + f"  {max(vals):.3e}")
    for r in rows:
        print(f"seed {r['seed']}: max|out64| {r['max_abs_out64']:.4f}, "
              f"layers {r['layers']}, checks {r['checks']}")
    result = {"card": card, "graph": "small" if args.small else "hgt_graph",
              "in_degree_max": degs, "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "iehgcn_precision.json"),
              "w") as f:
        json.dump(result, f)
    print(json.dumps({"max": {n: max(r["errs"][n] for r in rows)
                              for n in names}}))


if __name__ == "__main__":
    main()
