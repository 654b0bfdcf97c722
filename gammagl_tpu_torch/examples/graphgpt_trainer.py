"""GraphGPT trainer: stage-1 graph-text CLIP pretraining and stage-2
graph-token instruction tuning.

Twin of `examples/graphgpt/graphgpt_trainer.py`. Stage 1 (``--stage 1``,
the default): a `GraphTextCLIP` (embed 32, GNN hidden 32, text width 32,
vocabulary 1000, context 12) aligns the first 32 features' node
embeddings with token sequences, a batch of 8 (node ids, tokens) an epoch
from ``np.random.default_rng(epoch)`` (the batch of epoch 0 is drawn once
more for the init, as the script draws it), Adam at ``--lr``; then a
`GraphLlamaAdapter` (64 from 32) embeds every node for a language model.
Stage 2 (``--stage 2``): 16 nodes from ``np.random.default_rng(--seed)``,
prompts from the ``graphchat_v1`` template with 4 graph sentinels each
(`build_stage2_batch`, a character tokenizer, length 64), the answers
"class y"; a `GraphLlamaLM` (vocabulary 80, hidden 32, graph hidden 16,
one layer) tuned on the response tokens. The models are drawn on the
host from ``torch.manual_seed(--seed)`` and moved to ``--device``. The
same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.graphgpt_trainer --stage 2   # the card
    python -m gammagl_tpu_torch.examples.graphgpt_trainer --device cpu
"""

import time

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.models import (GraphLlamaAdapter, GraphLlamaLM,
                                      GraphTextCLIP, build_stage2_batch)
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device
from gammagl_tpu_torch.utils.conversation import get_conv_template
from gammagl_tpu_torch.utils.gfm_utils import DEFAULT_GRAPH_TOKEN

__all__ = ["parser", "main", "stage2", "toy_tokenizer"]


def parser():
    p = base_parser(__doc__.splitlines()[0], n_epoch=20, lr=0.003)
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    return p


def toy_tokenizer(s):
    """The scripts' character tokenizer: 2 + ord(c) % 60, 24 ids at most."""
    return [2 + (ord(c) % 60) for c in s][:24]


def _model(cls, seed, params, dev, **kw):
    torch.manual_seed(seed)
    model = cls(**kw)
    if params is not None:
        load_jax_params(model, params)
    return model.to(dev)


def stage2(args, data=None, params=None):
    """Graph-token instruction tuning; returns {"losses", "step_ms",
    "state", "inputs"} (inputs: x, edge_index, node ids, input ids and
    labels on the device). ``params``: a flax tree of the model (None:
    its own init)."""
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    data = node_data(args, data)
    x = np.asarray(data["x"])[:, :16].astype(np.float32)
    ei = np.asarray(data["edge_index"])
    y = np.asarray(data["y"])
    nodes = rng.permutation(x.shape[0])[:16]
    prompts, responses = [], []
    for v in nodes:
        conv = get_conv_template("graphchat_v1")
        conv.append_message(conv.roles[0],
                            f"Node {DEFAULT_GRAPH_TOKEN} category?")
        conv.append_message(conv.roles[1], None)
        prompts.append(conv.get_prompt()[-40:])
        responses.append(f"class {y[v]}")
    K = 4  # graph patches per sentinel
    ids, labels = build_stage2_batch(prompts, responses, toy_tokenizer,
                                     num_graph_tokens=K, max_len=64)
    node_ids = np.stack([np.full(K, v) for v in nodes])
    model = _model(GraphLlamaLM, args.seed, params, dev, vocab_size=80,
                   lm_hidden=32, graph_hidden=16, lm_layers=1, max_len=64,
                   in_channels=x.shape[1])
    inputs = tuple(torch.from_numpy(np.asarray(a)).to(dev)
                   for a in (x, ei, node_ids, ids, labels))
    state = TrainState(model, args.lr)
    losses, step_ms = [], []
    for epoch in range(args.n_epoch):
        t0 = time.perf_counter()
        loss, _ = model(*inputs)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if epoch % 10 == 0 or epoch == args.n_epoch - 1:
            print(f"stage-2 epoch {epoch:3d} instruction CE "
                  f"{losses[-1]:.4f}")
    return {"losses": losses, "step_ms": step_ms, "state": state,
            "inputs": inputs}


def clip_batch(seed, num_nodes, B=8, T=12, V=1000):
    """The stage-1 batch of an epoch: B node ids and (B, T) tokens."""
    r = np.random.default_rng(seed)
    return r.integers(0, num_nodes, B), r.integers(0, V, (B, T))


def main(args, data=None, params=None, adapter_params=None):
    """Stage 1 (or `stage2` with ``--stage 2``); returns {"losses",
    "step_ms", "state", "graph_tokens"}. ``params`` / ``adapter_params``:
    flax trees of the CLIP model and the adapter (None: their own
    init)."""
    if getattr(args, "stage", 1) == 2:
        return stage2(args, data, params)
    dev = resolve_device(args.device)
    data = node_data(args, data)
    x = torch.from_numpy(np.asarray(data["x"])[:, :32].astype(
        np.float32)).to(dev)
    ei = torch.from_numpy(np.asarray(data["edge_index"])).to(dev)
    n = x.shape[0]
    clip_batch(0, n)  # the script's init batch
    model = _model(GraphTextCLIP, args.seed, params, dev, embed_dim=32,
                   gnn_hidden=32, transformer_width=32, vocab_size=1000,
                   context_length=12, in_channels=x.shape[1])
    state = TrainState(model, args.lr)
    losses, step_ms = [], []
    for epoch in range(args.n_epoch):
        t0 = time.perf_counter()
        node_ids, tokens = (torch.from_numpy(a).to(dev)
                            for a in clip_batch(epoch, n))
        loss, _ = model(x, ei, node_ids, tokens)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if epoch % 5 == 0:
            print(f"epoch {epoch:3d} CLIP loss {losses[-1]:.4f}")
    # stage-2 ingredient: graph embeddings for the language model
    adapter = _model(GraphLlamaAdapter, 0, adapter_params, dev,
                     lm_hidden_size=64, graph_hidden_size=32,
                     in_channels=x.shape[1]).eval()
    with torch.no_grad():
        g_emb = adapter(x, ei)
    print("graph tokens for the LM:", tuple(g_emb.shape))
    return {"losses": losses, "step_ms": step_ms, "state": state,
            "graph_tokens": g_emb}


if __name__ == "__main__":
    main(parser().parse_args())
