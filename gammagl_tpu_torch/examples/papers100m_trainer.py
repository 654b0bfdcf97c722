"""ogbn-papers100M-scale full-graph GCN (or SIGN) training on a halo
partition, one part a process.

Twin of `examples/papers100m/papers100m_trainer.py` and of the one-chip
recipe `scripts/papers100m_single_chip.py`: the graph staged in OGB's
layout under ``--data-root`` (``<root>/ogbn_papers100M/raw/{node_feat,
edge_index,node_label}.npy`` and ``split/time/{train,valid}.npy``, read
by `datasets.OgbNodeDataset` as memory maps), else the npy files named
by ``--features`` / ``--edges-file`` / ``--labels`` / ``--train-idx`` /
``--val-idx``, else a synthetic power-law, homophilous citation graph at
``--scale`` of papers100M (the same generator, seed and arrays);
``--rcm`` reorders the nodes by reverse Cuthill-McKee first
(`reorder_bandwidth`); then self-loops, GCN norms on the host, a planned
halo partition with `auto_src_blocks` source blocks, node features
resident in the compute dtype, and the layer-staged trainer
(`make_partitioned_gcn_train_staged`; ``--monolithic`` for the autograd
one).

Without a process group the run is one part in one process. Under an
initialised ``torch.distributed`` world of P processes (``torchrun``: the
script joins its ``env://`` group, `join_launcher_group`), each process runs
one part: a partition of P parts, or with ``--slices S`` the two-level
partition of an (S, P / S) grid (`build_hier_halo_partition_planned`,
``--flat``: `build_hier_halo_partition`), and only rank 0 prints. On the card every aggregation runs the CSR SpMM kernel and its
accumulating form; on the CPU their plain versions. Without ``--scale``
the shard is the largest whose `estimate_hbm_gb` fits ``--hbm-gb``.
``--ckpt DIR`` (gcn recipe) resumes from DIR's complete sharded
checkpoint (`train.save_checkpoint_sharded`: the parameters and AdamW's
state, a file a process) and saves one every ``--ckpt-every`` epochs and
at the end, as the JAX twin does with Orbax.

    python -m gammagl_tpu_torch.examples.papers100m_trainer          # card
    python -m gammagl_tpu_torch.examples.papers100m_trainer \\
        --device cpu --scale 0.00002 --epochs 3
    torchrun --nproc-per-node 4 -m \\
        gammagl_tpu_torch.examples.papers100m_trainer --slices 2 \\
        --scale 0.001 --epochs 3                      # a (2, 2) grid

Prints per-epoch loss, ms and edges/s, and one JSON line (the median
epoch from the third on). The one-chip script's extrapolation to a pod
slice is not part of the twin; `parallel.scaling` models the card.
"""

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.datasets import OgbNodeDataset
from gammagl_tpu_torch.parallel import (auto_src_blocks,
                                        build_halo_partition,
                                        build_halo_partition_planned,
                                        build_hier_halo_partition,
                                        build_hier_halo_partition_planned,
                                        estimate_hbm_gb,
                                        make_partitioned_gcn_train,
                                        make_partitioned_gcn_train_staged,
                                        reorder_bandwidth, shard_nodes,
                                        sign_precompute, traffic_report,
                                        world)
from gammagl_tpu_torch.examples.common import (checkpoint_tree,
                                               restore_checkpoint_tree)
from gammagl_tpu_torch.parallel.full_graph import jax_labels
from gammagl_tpu_torch.train import (load_checkpoint_sharded,
                                     save_checkpoint_sharded)
from gammagl_tpu_torch.train.state import STEP_FILE
from gammagl_tpu_torch.utils import (calc_gcn_norm_np, index_to_mask,
                                     resolve_device)

__all__ = ["synthetic_papers", "solve_scale", "load_ogb_root", "load_real",
           "load_data", "parser", "prepare", "train", "main"]

PAPERS_N = 111_059_956
PAPERS_E = 1_615_685_872
AVG_DEG = PAPERS_E / PAPERS_N


def synthetic_papers(scale, seed=0, homophily=0.7):
    """Power-law-ish homophilous citation graph at ``scale`` x papers100M
    (citations stay within the field ~70% of the time; features carry the
    label's direction so training has signal). Returns (edge_index (2, E)
    int64, x (N, 128) float32, y (N,) int32, train mask, val mask, 172)."""
    n = max(int(PAPERS_N * scale), 256)
    e = max(int(PAPERS_E * scale), 4 * n)
    f, c = 128, 172
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    dst = rng.integers(0, n, e)
    # src: same class as dst w.p. homophily, else zipf-clamped anywhere
    order = np.argsort(y, kind="stable")
    counts = np.bincount(y, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    same = order[starts[y[dst]]
                 + (rng.random(e) * counts[y[dst]]).astype(np.int64)]
    anywhere = (rng.zipf(1.35, e).astype(np.int64) - 1) % n
    src = np.where(rng.random(e) < homophily, same, anywhere)
    ei = np.stack([src, dst])
    x = rng.normal(size=(n, f)).astype(np.float32) * 0.5
    proto = rng.normal(size=(c, f)).astype(np.float32)
    x += proto[y]
    train = rng.random(n) < 0.01
    val = ~train & (rng.random(n) < 0.005)
    return ei, x, y, train, val, c


def load_ogb_root(root, name="ogbn-papers100M"):
    """The graph staged in OGB's layout under ``root``
    (`datasets.OgbNodeDataset`), as `synthetic_papers` returns it; the
    features and edges stay memory-mapped until the partition and
    `shard_nodes` read them."""
    g = OgbNodeDataset(root, name)[0]
    y = (np.asarray(g.y).astype(np.int32) if "y" in g
         else np.zeros(g.num_nodes, np.int32))
    masks = [np.asarray(g[k]) if k in g else np.zeros(g.num_nodes, bool)
             for k in ("train_mask", "val_mask")]
    return g.edge_index, g.x, y, *masks, max(int(y.max()) + 1, 2)


def load_real(args):
    """The npy files of ``args.features``, ``edges_file``, ``labels``,
    ``train_idx`` and ``val_idx`` (optional), as `synthetic_papers`
    returns them. OGB stores labels as (N, 1) float with NaN on rows
    without one; those become -1."""
    x = np.load(args.features, mmap_mode="r")
    ei = np.load(args.edges_file, mmap_mode="r")
    y = np.asarray(np.load(args.labels, mmap_mode="r")).reshape(-1)
    y = np.nan_to_num(y, nan=-1.0).astype(np.int32)
    mask = index_to_mask(np.load(args.train_idx), x.shape[0])
    val = np.zeros(x.shape[0], bool)
    if args.val_idx:
        val = index_to_mask(np.load(args.val_idx), x.shape[0])
    return ei, x, y, mask, val, int(y.max()) + 1


def load_data(args, scale):
    """What the run trains on: ``--data-root`` first, then
    ``--features``, then the synthetic graph at ``scale``."""
    if args.data_root:
        return load_ogb_root(args.data_root, args.ogb_name)
    if args.features:
        return load_real(args)
    return synthetic_papers(scale)


def solve_scale(hbm_gb, feat_dim, hidden, layers):
    """The largest scale whose one-part `estimate_hbm_gb` (bf16, remat)
    fits ``hbm_gb``: the estimate is linear in the node count at a fixed
    degree, so one evaluation gives the slope."""
    probe_n = 1_000_000
    gb = estimate_hbm_gb(probe_n, feat_dim, hidden, layers, 1, AVG_DEG,
                         torch.bfloat16, True)
    return int(probe_n * hbm_gb / float(gb)) / PAPERS_N


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--recipe", choices=["gcn", "sign"], default="gcn")
    p.add_argument("--scale", type=float, default=None,
                   help="synthetic fraction of papers100M (default: the "
                        "largest that --hbm-gb fits)")
    p.add_argument("--hbm-gb", type=float, default=8.0,
                   help="device budget for the shard when --scale is not "
                        "given")
    p.add_argument("--data-root", default=None,
                   help="root of OGB's staged layout (<root>/"
                        "ogbn_papers100M/raw and split/; see "
                        "datasets/ogb.py); takes precedence over "
                        "--features / --edges-file")
    p.add_argument("--ogb-name", default="ogbn-papers100M")
    p.add_argument("--features", default=None,
                   help="node features, an (N, F) npy file")
    p.add_argument("--edges-file", default=None,
                   help="edges, a (2, E) npy file")
    p.add_argument("--labels", default=None, help="labels, an npy file")
    p.add_argument("--train-idx", default=None,
                   help="training node ids, an npy file")
    p.add_argument("--val-idx", default=None,
                   help="validation node ids, an npy file")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--hops", type=int, default=3, help="SIGN sweeps")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--f32", action="store_true",
                   help="float32 activations and features (default bf16)")
    p.add_argument("--no-remat", action="store_true",
                   help="--monolithic without per-layer recomputation")
    p.add_argument("--monolithic", action="store_true",
                   help="autograd through the tier "
                        "(make_partitioned_gcn_train) instead of the "
                        "layer-staged step")
    p.add_argument("--flat", action="store_true",
                   help="the flat halo tier (plain PyTorch segment sum) "
                        "instead of the planned tier's kernels")
    p.add_argument("--src-blocks", type=int, default=None,
                   help="interior source blocks (default auto_src_blocks)")
    p.add_argument("--no-balance", action="store_true",
                   help="keep the natural node order (no degree-balanced "
                        "relabeling; the identity with one part anyway)")
    p.add_argument("--rcm", action="store_true",
                   help="reorder the nodes by reverse Cuthill-McKee before "
                        "partitioning (smaller halos)")
    p.add_argument("--slices", type=int, default=1,
                   help=">1: the two-level halo over a (slices, P / "
                        "slices) grid of the torch.distributed world's P "
                        "processes (parallel/hier_halo.py)")
    p.add_argument("--ckpt", default=None,
                   help="directory of a sharded checkpoint (gcn recipe): "
                        "resume from it when it holds a complete one, save "
                        "every --ckpt-every epochs and at the end")
    p.add_argument("--ckpt-every", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (default, the card) or cpu")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_sum(*ts):
    """The tensors summed over the world's processes (none without a
    group), in place."""
    if world()[1] > 1:
        for t in ts:
            dist.all_reduce(t)
    return ts


def _val_acc(logits, ys, vs):
    pred = logits.argmax(1)
    hit, tot = _all_sum(((pred == ys.long()) & (vs > 0)).sum().float(),
                        vs.sum().float())
    return float(hit / tot.clamp_min(1))


def _say(*args, **kwargs):
    """print on rank 0 only."""
    if world()[0] == 0:
        print(*args, **kwargs)


def _train_sign(args, part, xs, ys, ms, vs, c, cdtype, device):
    """SIGN: K sweeps once, then a two-layer MLP on the concatenated
    operands (optax.adamw's default decay 1e-4, as in the JAX trainer)."""
    t = time.perf_counter()
    feats = torch.cat(sign_precompute(part, xs, args.hops,
                                      store_dtype=cdtype), 1)
    _sync(device)
    _say(f"SIGN precompute ({args.hops} sweeps): "
          f"{time.perf_counter() - t:.2f}s; training is graph-free")
    rng = np.random.default_rng(0)
    d_in = feats.shape[1]
    p = {"w1": rng.normal(size=(d_in, args.hidden)) * (2.0 / d_in) ** 0.5,
         "b1": np.zeros(args.hidden),
         "w2": rng.normal(size=(args.hidden, c)) * (2.0 / args.hidden) ** 0.5,
         "b2": np.zeros(c)}
    p = {k: torch.tensor(v, dtype=torch.float32, device=device,
                         requires_grad=True) for k, v in p.items()}
    opt = torch.optim.AdamW(list(p.values()), lr=args.lr, eps=1e-8,
                            weight_decay=1e-4)

    def fwd(h):
        h = torch.relu(h @ p["w1"].to(cdtype) + p["b1"].to(cdtype))
        return (h @ p["w2"].to(cdtype) + p["b2"].to(cdtype)).float()

    losses, times = [], []
    m = ms.float()
    msum, = _all_sum(m.sum())  # the mean runs over every part's rows
    for epoch in range(args.epochs):
        t = time.perf_counter()
        ls = torch.nn.functional.cross_entropy(
            fwd(feats), jax_labels(ys, c), reduction="none")
        loss = (ls * m).sum() / msum.clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, *_ = _all_sum(loss.detach(), *(t.grad for t in p.values()))
        opt.step()
        _sync(device)
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            with torch.no_grad():
                va = _val_acc(fwd(feats), ys, vs)
            _say(f"epoch {epoch:3d}  loss {losses[-1]:.4f}  val acc "
                 f"{va:.4f}  {times[-1] * 1e3:.1f} ms")
    return losses, times


def prepare(args, data=None):
    """Everything before the first step: the graph (``data``, as
    `synthetic_papers` returns it, else `load_data`), self-loops, GCN
    norms, the partition and the per-node tensors on the device. Returns
    a dict of them and the set-up numbers the JSON line reports."""
    device = resolve_device(args.device)
    cdtype = torch.float32 if args.f32 else torch.bfloat16
    staged = data is None and bool(args.data_root or args.features)
    scale = None if staged else (args.scale or solve_scale(
        args.hbm_gb, 128, args.hidden, args.layers))
    t0 = time.perf_counter()
    ei, x, y, train_mask, val_mask, c = (data if data is not None
                                         else load_data(args, scale))
    n, f = x.shape
    _, nparts, _ = world()
    if args.slices > 1 and nparts == 1:
        raise ValueError("--slices > 1 needs an initialised "
                         "torch.distributed world of several processes "
                         "(torchrun), one part a process")
    if args.slices < 1 or nparts % args.slices:
        raise ValueError(f"--slices {args.slices} does not divide the "
                         f"{nparts} processes of the torch.distributed "
                         "world")
    est = estimate_hbm_gb(n, f, args.hidden, args.layers, nparts,
                          ei.shape[1] / max(n, 1), cdtype,
                          not args.no_remat)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    what = "staged files" if staged else f"scale {scale:.6f}"
    _say(f"graph: {what} -> {n:,} nodes, {ei.shape[1]:,} edges, "
         f"{f} feats, {c} classes; est {est:.2f} GB on {name} "
         f"(ready in {time.perf_counter() - t0:.1f}s)", flush=True)

    if args.rcm:
        perm, inv = reorder_bandwidth(ei, n)
        ei = inv[np.asarray(ei)]
        x, y, train_mask, val_mask = (x[perm], y[perm], train_mask[perm],
                                      val_mask[perm])

    t0 = time.perf_counter()
    ei = np.concatenate(  # self-loops, as the reference gcn_trainer
        [np.asarray(ei), np.tile(np.arange(n, dtype=np.int64), (2, 1))], 1)
    w = calc_gcn_norm_np(ei, n)
    nsb = None
    balance = not args.no_balance
    tier = "flat" if args.flat else "planned"
    if args.slices > 1:
        S, D = args.slices, nparts // args.slices
        if args.flat:
            part = base = build_hier_halo_partition(ei, n, S, D, w,
                                                    balance=balance)
        else:
            part = build_hier_halo_partition_planned(ei, n, S, D, w,
                                                     balance=balance)
            base = part.base
        rep = traffic_report(base, max(f, args.hidden), cdtype)
        detail = (f"{S}x{D} grid, halo intra {base.h_intra:,} / inter "
                  f"{base.h_inter:,}; between slices "
                  f"{rep['dcn_bytes'] / 1e6:.1f} MB a layer (dedup "
                  f"{rep['dcn_dedup_factor']:.1f}x vs flat)")
        tier = "hier-" + tier
    elif args.flat:
        part = build_halo_partition(ei, n, nparts, w, balance=balance)
        detail = ""
    else:
        nsb = args.src_blocks or auto_src_blocks(
            -(-n // nparts), max(f, args.hidden), cdtype)
        part = build_halo_partition_planned(ei, n, nparts, w,
                                            num_src_blocks=nsb,
                                            balance=balance)
        detail = (f"{len(part.interior)} interior plans over {nsb} source "
                  f"blocks")
    if nparts > 1:
        detail = f"{nparts} parts" + (", " if detail else "") + detail
    t_part = time.perf_counter() - t0
    _say(f"partition ({tier}): rows {part.rows_per:,}"
         + (", " if detail else "") + f"{detail} ({t_part:.1f}s)",
         flush=True)

    t0 = time.perf_counter()
    xs = shard_nodes(x, part, device=device, dtype=cdtype)
    ys = shard_nodes(y, part, device=device)
    ms = shard_nodes(train_mask.astype(np.float32), part, device=device)
    vs = shard_nodes(val_mask.astype(np.float32), part, device=device)
    _sync(device)
    _say(f"transfer: {xs.numel() * xs.element_size() / 1e9:.2f} GB in "
         f"{time.perf_counter() - t0:.1f}s", flush=True)

    return {"device": device, "cdtype": cdtype, "scale": scale, "n": n,
            "f": f, "c": c, "edges": int(ei.shape[1]), "est": est,
            "name": name, "part": part, "nsb": nsb, "tier": tier,
            "t_part": t_part, "xs": xs, "ys": ys, "ms": ms, "vs": vs}


def train(args, prep):
    """``args.epochs`` steps of the recipe on what `prepare` gave; prints
    each epoch and the JSON line, and returns a dict with ``losses``,
    ``epoch_ms``, the JSON line's fields and (gcn) the final ``params``.
    With ``args.ckpt`` the gcn recipe resumes from the directory's
    complete sharded checkpoint (its step is the next epoch), saves one
    every ``args.ckpt_every`` epochs and one at the end; ``losses`` are
    the epochs this run took."""
    device, cdtype, part = prep["device"], prep["cdtype"], prep["part"]
    xs, ys, ms, vs = prep["xs"], prep["ys"], prep["ms"], prep["vs"]
    f, c, n, E = prep["f"], prep["c"], prep["n"], prep["edges"]

    extra = {}
    if args.recipe == "sign":
        losses, times = _train_sign(args, part, xs, ys, ms, vs, c, cdtype,
                                    device)
    else:
        if args.monolithic:
            params, opt, step, eval_logits = make_partitioned_gcn_train(
                part, f, args.hidden, c, num_layers=args.layers,
                compute_dtype=cdtype, remat=not args.no_remat,
                learning_rate=args.lr, device=device)
        else:
            params, opt, step, eval_logits = \
                make_partitioned_gcn_train_staged(
                    part, f, args.hidden, c, num_layers=args.layers,
                    compute_dtype=cdtype, learning_rate=args.lr,
                    device=device)
        losses, times = [], []
        start = 0
        if args.ckpt and osp.exists(osp.join(args.ckpt, STEP_FILE)):
            tree, start = load_checkpoint_sharded(
                args.ckpt, checkpoint_tree(params, opt))
            restore_checkpoint_tree(params, opt, tree)
            _say(f"resumed from {args.ckpt} at epoch {start}", flush=True)
        for epoch in range(start, args.epochs):
            t = time.perf_counter()
            params, opt, loss = step(params, opt, xs, ys, ms)
            loss = float(loss)  # waits for the step
            times.append(time.perf_counter() - t)
            losses.append(loss)
            if args.ckpt and (epoch + 1) % args.ckpt_every == 0:
                save_checkpoint_sharded(args.ckpt,
                                        checkpoint_tree(params, opt),
                                        step=epoch + 1)
            line = (f"epoch {epoch:3d}  loss {loss:.4f}  "
                    f"{times[-1] * 1e3:.1f} ms  "
                    f"({E / times[-1]:.3e} edges/s)")
            if epoch % 5 == 0 or epoch == args.epochs - 1:
                va = _val_acc(eval_logits(params, xs), ys, vs)
                line += f"  val acc {va:.4f}"
            _say(line, flush=True)
        if args.ckpt:
            save_checkpoint_sharded(args.ckpt, checkpoint_tree(params, opt),
                                    step=args.epochs)
            _say(f"checkpoint saved to {args.ckpt}", flush=True)
        extra = {"params": {k: v.detach() for k, v in params.items()}}

    steady = times[2:] or times
    sustained = (sorted(steady)[len(steady) // 2] if steady
                 else float("nan"))
    payload = {
        "metric": f"papers100m_{args.recipe}_epoch",
        "shard_nodes": int(n), "shard_edges": E,
        "scale": prep["scale"], "layers": args.layers, "hidden": args.hidden,
        "feat_dim": int(f), "dtype": str(cdtype).replace("torch.", ""),
        "tier": prep["tier"], "src_blocks": prep["nsb"],
        "staged": not args.monolithic, "parts": part.num_parts,
        "slices": args.slices, "rcm": bool(args.rcm),
        "partition_s": prep["t_part"],
        "sustained_epoch_ms": sustained * 1e3,
        "edges_per_s": E / sustained,
        "est_hbm_gb": float(prep["est"]), "device": prep["name"],
        "losses": losses}
    _say(json.dumps(payload), flush=True)
    return {**payload, "epoch_ms": [t * 1e3 for t in times], **extra}




def main(args, data=None):
    """Train; returns what `train` returns. ``data`` replaces the loaded
    or generated graph (edge_index, x, y, train, val, num_classes)."""
    return train(args, prepare(args, data))


def launcher_backend(device_type, local_world, cards):
    """The ``torch.distributed`` backend for ``local_world`` processes of
    one host with ``cards`` visible cards: NCCL when each process has a
    card of its own, gloo on the CPU or when the processes outnumber the
    cards (NCCL refuses two ranks on one device; gloo moves CUDA tensors
    through host memory)."""
    if device_type != "cuda" or local_world > cards:
        return "gloo"
    return "nccl"


def join_launcher_group(device):
    """Join the ``env://`` group that a launcher such as ``torchrun``
    describes in the environment (``WORLD_SIZE`` > 1), one part a
    process, on the card ``LOCAL_RANK`` modulo the visible cards, with
    `launcher_backend`'s backend. Returns whether it joined."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
    dist.init_process_group(launcher_backend(device.type, local_world,
                                             cards))
    return True


if __name__ == "__main__":
    args = parser().parse_args()
    joined = join_launcher_group(resolve_device(args.device))
    try:
        main(args)
    finally:
        if joined:
            dist.destroy_process_group()
