"""The system under test for hgt-ogbn-mag: the port's `models.HGTModel`
(hidden 256, 4 heads of 64, 2 layers, bf16 attention) on the relations'
CSR plans (`HeteroGraph.csr_plans`), served by `examples.common.predict`
and trained by `examples.common.train_step`, as the port's hgt twin
drives it.

The benchmark makes the graph, the features and every weight from the
seed on the device, in its own names (`make_weights`), and copies them
into the parameters of the model the port built; the reference reads the
same names.
"""

import torch

from graphs.mag import RELATIONS, mag_graph, paper_features

TYPES = ("paper", "author")


def _graph_args(cfg):
    g = cfg["graph"]
    return {"graph_seed": g["graph_seed"], "scale": g["scale"],
            "edge_scale": g.get("edge_scale", 1.0),
            "feat_dim": cfg["feat_dim"]}


def receivers():
    return [nt for nt in TYPES if any(r[2] == nt for r in RELATIONS)]


def make_weights(cfg, seed, device):
    """Every weight, in the benchmark's names: matrices glorot-uniform from
    one draw of a generator on the device, biases 0, each relation's
    priors and each type's skip weight 1."""
    H, D, C = cfg["heads"], cfg["head_dim"], cfg["num_classes"]
    HD, F = cfg["hidden_dim"], cfg["feat_dim"]
    mats, const = {}, {}
    for nt in TYPES:
        mats[f"proj.{nt}.w"] = (HD, F)
        const[f"proj.{nt}.b"] = ((HD,), 0.0)
    for i in range(cfg["num_layers"]):
        for role in ("k", "q", "v"):
            for nt in TYPES:
                mats[f"conv{i}.{role}.{nt}.w"] = (HD, HD)
                const[f"conv{i}.{role}.{nt}.b"] = ((HD,), 0.0)
        for rel in RELATIONS:
            r = "__".join(rel)
            mats[f"conv{i}.a_rel.{r}"] = (H, D, D)
            mats[f"conv{i}.m_rel.{r}"] = (H, D, D)
            const[f"conv{i}.pri.{r}"] = ((H,), 1.0)
        for nt in receivers():
            mats[f"conv{i}.out.{nt}.w"] = (HD, HD)
            const[f"conv{i}.out.{nt}.b"] = ((HD,), 0.0)
            const[f"conv{i}.skip.{nt}"] = ((), 1.0)
    mats["head.w"] = (C, HD)
    const["head.b"] = ((C,), 0.0)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    total = sum(torch.Size(s).numel() for s in mats.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for name, shape in mats.items():
        lead = torch.Size(shape[:-2]).numel()
        lim = (6.0 / ((shape[-2] + shape[-1]) * lead)) ** 0.5
        size = torch.Size(shape).numel()
        out[name] = (u[off:off + size] * lim).view(shape)
        off += size
    for name, (shape, value) in const.items():
        out[name] = torch.full(shape, value, device=device)
    return out


def make_inputs(cfg, seed, device):
    edges, counts, x_author, y = mag_graph(seed=seed, device=device,
                                           **_graph_args(cfg))
    return {"edges": edges, "counts": counts, "x_author": x_author, "y": y,
            "weights": make_weights(cfg, seed, device),
            "checksum": tuple(int(a.sum()) + 3 * int(b.sum())
                              for a, b in edges.values())}


def request_features(cfg, seed, index, counts, device):
    return paper_features(seed, index, counts["paper"], cfg["feat_dim"],
                          device)


def named_params(model, num_layers):
    """[(parameter of the port's `HGTModel`, the benchmark's name)]."""
    out = []
    for nt in TYPES:
        out += [(model.proj[nt].weight, f"proj.{nt}.w"),
                (model.proj[nt].bias, f"proj.{nt}.b")]
    for i in range(num_layers):
        conv = model.convs[i]
        for role, lins in (("k", conv.k_lin), ("q", conv.q_lin),
                           ("v", conv.v_lin)):
            for nt in TYPES:
                out += [(lins[nt].weight, f"conv{i}.{role}.{nt}.w"),
                        (lins[nt].bias, f"conv{i}.{role}.{nt}.b")]
        for rel in RELATIONS:
            r = "__".join(rel)
            out += [(conv.a_rel[r], f"conv{i}.a_rel.{r}"),
                    (conv.m_rel[r], f"conv{i}.m_rel.{r}"),
                    (conv.pri[r], f"conv{i}.pri.{r}")]
        for nt in receivers():
            out += [(conv.out_lin[nt].weight, f"conv{i}.out.{nt}.w"),
                    (conv.out_lin[nt].bias, f"conv{i}.out.{nt}.b"),
                    (conv.skip[nt], f"conv{i}.skip.{nt}")]
    return out + [(model.lin.weight, "head.w"), (model.lin.bias, "head.b")]


def load_weights(model, weights, num_layers):
    """Copy the benchmark's weights into the port's `HGTModel`."""
    with torch.no_grad():
        for param, name in named_params(model, num_layers):
            param.copy_(weights[name])


def forward_work(cfg, counts, edges_per_rel):
    """One forward's dense products and attention, from the model's
    shapes (harness/work.py)."""
    H, D, HD = cfg["heads"], cfg["head_dim"], cfg["hidden_dim"]
    F, C, cd = cfg["feat_dim"], cfg["num_classes"], cfg["compute_dtype"]
    item = {"bfloat16": 2, "float32": 4}[cd]
    mm, att = [], []
    for nt in TYPES:
        mm.append({"m": counts[nt], "k": F, "n": HD, "dtype": "float32"})
    for _ in range(cfg["num_layers"]):
        for nt in TYPES:
            for _role in "kqv":
                mm.append({"m": counts[nt], "k": HD, "n": HD, "dtype": cd})
        for rel in RELATIONS:
            for _map in ("a_rel", "m_rel"):
                mm.append({"m": counts[rel[0]] * H, "k": D, "n": D,
                           "dtype": cd})
            att.append({"dst": counts[rel[2]], "src": counts[rel[0]],
                        "edges": edges_per_rel[rel], "heads": H, "dim": D,
                        "itemsize": item, "dtype": cd, "pass": "fwd"})
        for nt in receivers():
            mm.append({"m": counts[nt], "k": HD, "n": HD,
                       "dtype": "float32"})
    mm.append({"m": counts["paper"], "k": HD, "n": C, "dtype": "float32"})
    return {"matmul": mm, "attention": att}


def _port_model(cfg, inputs, device, phases):
    from gammagl_tpu_torch.data import HeteroGraph
    from gammagl_tpu_torch.models import HGTModel

    hg = HeteroGraph()
    for nt, n in inputs["counts"].items():
        hg[nt].num_nodes = n
    for rel, (s, d) in inputs["edges"].items():
        hg[rel].edge_index = torch.stack([s, d]).cpu().numpy()
    plans = hg.csr_plans()
    phases.mark("plan (a CSR plan a relation, `HeteroGraph.csr_plans`)")
    model = HGTModel(hg.metadata(), cfg["hidden_dim"], cfg["num_classes"],
                     "paper", heads=cfg["heads"],
                     num_layers=cfg["num_layers"],
                     dtype=getattr(torch, cfg["compute_dtype"]),
                     in_channels=cfg["feat_dim"]).to(device)
    load_weights(model, inputs["weights"], cfg["num_layers"])
    ei = {rel: torch.stack([s, d]) for rel, (s, d) in inputs["edges"].items()}
    return model, plans, ei


class Server:
    """``request(x_paper)``: the window's call, `common.predict` with the
    plans; the logits stay on the device."""

    def __init__(self, cfg, inputs, device, phases, seed):
        from gammagl_tpu_torch.examples import common

        self.cfg, self.seed, self.device = cfg, seed, device
        self.counts = inputs["counts"]
        self.model, self.plans, self.ei = _port_model(cfg, inputs, device,
                                                      phases)
        self.x_author = inputs["x_author"]
        self._predict = common.predict
        phases.mark("model (`HGTModel`, the weights)")

    def features(self, index):
        return request_features(self.cfg, self.seed, index, self.counts,
                                self.device)

    def request(self, x_paper):
        return self._predict(self.model, {"paper": x_paper,
                                          "author": self.x_author},
                             self.ei, plan_dict=self.plans)

    def free(self):
        del self.model, self.plans, self.ei, self.x_author


def build_server(cfg, seed, device, phases):
    inputs = make_inputs(cfg, seed, device)
    counts = inputs["counts"]
    phases.mark(f"graph ({counts['paper']} papers, {counts['author']} "
                f"authors, {sum(s.numel() for s, _ in inputs['edges'].values())}"
                " edges, on the device)")
    server = Server(cfg, inputs, device, phases, seed)
    server.work = forward_work(cfg, counts, {r: s.numel() for r, (s, _)
                                             in inputs["edges"].items()})
    server.checksum = inputs["checksum"]
    return server


def train_inputs(cfg, seed, inputs, device):
    """The training side's inputs beside the graph: the paper features
    (N(0, 1) from the seed) and ``step_masks`` disjoint masks, each an
    equal share of ogbn-mag's training papers (``train_share``), the
    labelled rows of successive steps."""
    n = inputs["counts"]["paper"]
    x_paper = paper_features(seed, -1_000_000, n, cfg["feat_dim"], device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    u = torch.rand(n, generator=gen, device=device)
    k, share = cfg["step_masks"], cfg["train_share"]
    masks = [((u >= i * share / k) & (u < (i + 1) * share / k)).float()
             for i in range(k)]
    return x_paper, masks


def mask_generator(seed, device):
    """The generator the attention masks are drawn from, in the order the
    layers and relations draw them."""
    return torch.Generator(device=device).manual_seed(int(seed) + 3)


def train_work(cfg, counts, edges_per_rel):
    """One training step: the forward, the dense products' two gradients
    (dx and dW; the first projection's input needs no dx), and the
    attention's backward."""
    fwd = forward_work(cfg, counts, edges_per_rel)
    mm = list(fwd["matmul"])
    for i, it in enumerate(fwd["matmul"]):
        mm.append(dict(it, m=it["k"], k=it["m"]))          # dW
        if i >= len(TYPES):                                # dx
            mm.append(dict(it, k=it["n"], n=it["k"]))
    att = fwd["attention"] + [dict(it, **{"pass": "bwd"})
                              for it in fwd["attention"]]
    return {"matmul": mm, "attention": att}


class Trainer:
    """``step(i)``: the window's call, `common.train_step` with Adam, the
    plans and the attention masks' generator, on step mask i mod the
    masks."""

    def __init__(self, cfg, inputs, device, phases, seed):
        from gammagl_tpu_torch.examples import common
        from gammagl_tpu_torch.train import TrainState

        self.model, self.plans, self.ei = _port_model(cfg, inputs, device,
                                                      phases)
        self.ms = inputs["masks"]
        self.x = {"paper": inputs["x_paper"], "author": inputs["x_author"]}
        self.y = inputs["y"]
        self.state = TrainState(self.model, cfg["learning_rate"])
        self.gen = inputs["mask_generator"]
        self.names = named_params(self.model, cfg["num_layers"])
        self._train_step = common.train_step
        phases.mark("trainer (`HGTModel`, `TrainState`, the weights)")

    def step(self, i):
        return self._train_step(self.state, self.x, self.ei, self.y,
                                self.ms[i % len(self.ms)],
                                plan_dict=self.plans, generator=self.gen)

    def first_grads(self):
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for p, name in self.names:
            st = opt.state.get(p)
            out[name] = (st["exp_avg"].detach().clone() / (1 - beta1)
                         if st else torch.zeros_like(p))
        return out

    def snapshot(self):
        return {name: p.detach().clone() for p, name in self.names}

    @property
    def params(self):
        return {name: p for p, name in self.names}

    @property
    def opt(self):
        return self.state.optimizer

    def free(self):
        del self.model, self.plans, self.ei, self.x, self.y, self.state
        del self.names, self.ms


def make_train_inputs(cfg, seed, device):
    inputs = make_inputs(cfg, seed, device)
    inputs["x_paper"], inputs["masks"] = train_inputs(cfg, seed, inputs,
                                                      device)
    inputs["mask_generator"] = mask_generator(seed, device)
    return inputs


def build_trainer(cfg, seed, device, phases):
    inputs = make_train_inputs(cfg, seed, device)
    counts = inputs["counts"]
    phases.mark(f"graph ({counts['paper']} papers, {counts['author']} "
                f"authors, {sum(s.numel() for s, _ in inputs['edges'].values())}"
                " edges, on the device)")
    trainer = Trainer(cfg, inputs, device, phases, seed)
    trainer.work = train_work(cfg, counts, {r: s.numel() for r, (s, _)
                                            in inputs["edges"].items()})
    trainer.init = {k: v.clone() for k, v in inputs["weights"].items()}
    trainer.checksum = inputs["checksum"]
    return trainer
