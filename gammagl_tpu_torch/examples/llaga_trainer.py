"""LLaGA instruction tuning with structure-aware templates.

Twin of `examples/llaga/llaga_trainer.py`: ``--batch_size`` target nodes
from ``np.random.default_rng(--seed)``, each encoded by a template of its
neighbourhood, neighborhood-detail (``--template nd``: a sampled tree of
3 children a node over 2 hops, `llaga_neighborhood_detail` seeded
``--seed``, through `LLaGAProjector` with its hop separators) or
hop-field (``ho``: mean features of each hop ring, `llaga_hop_field`,
through `LLaGAEncoder`), on the first 16 features; the tokens spliced at
the ``llaga_llama_2`` prompt's graph sentinels; a one-layer
`TinyCausalLM` (vocabulary 80, hidden 32, length 96) tuned on the answers
"class y" with Adam at ``--lr``. The model is drawn on the host from
``torch.manual_seed(--seed)`` and moved to ``--device``. The same flags,
plus ``--device``.

    python -m gammagl_tpu_torch.examples.llaga_trainer --template ho   # the card
    python -m gammagl_tpu_torch.examples.llaga_trainer --device cpu
"""

import time

import numpy as np
import torch
from torch import nn

from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.examples.graphgpt_trainer import toy_tokenizer
from gammagl_tpu_torch.models import (LLaGAEncoder, LLaGAProjector,
                                      TinyCausalLM, llaga_hop_field,
                                      llaga_neighborhood_detail,
                                      splice_graph_embeddings)
from gammagl_tpu_torch.models.graph_llm import _next_token_loss
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device
from gammagl_tpu_torch.utils.conversation import get_conv_template
from gammagl_tpu_torch.utils.gfm_utils import (DEFAULT_GRAPH_TOKEN,
                                               GRAPH_TOKEN_INDEX,
                                               IGNORE_INDEX)

__all__ = ["LLaGAModel", "parser", "main", "llaga_batch"]


class LLaGAModel(nn.Module):
    """The script's model: the template's encoder (flax ``enc``) and a
    `TinyCausalLM` (``lm``) with sentinel splicing; the forward gives the
    next-token loss on the labelled positions."""

    def __init__(self, num_graph_tokens, template="nd", vocab=80, hidden=32,
                 use_hop=2, sample_size=3, in_channels=None):
        super().__init__()
        self.num_graph_tokens, self.template = num_graph_tokens, template
        self.lm = TinyCausalLM(vocab_size=vocab, hidden=hidden, layers=1,
                               max_len=96)
        self.enc = (LLaGAProjector(hidden, use_hop=use_hop,
                                   sample_size=sample_size,
                                   in_channels=in_channels)
                    if template == "nd" else
                    LLaGAEncoder(hidden, num_hops=use_hop,
                                 in_channels=in_channels))

    def flax_tree(self):
        return {"lm": self.lm, "enc": self.enc}

    def forward(self, graph_inputs, input_ids, labels):
        g_tokens = (self.enc(*graph_inputs) if self.template == "nd"
                    else self.enc(graph_inputs))
        safe = torch.where(input_ids == GRAPH_TOKEN_INDEX, 0, input_ids)
        spliced = splice_graph_embeddings(input_ids, self.lm.embed(safe),
                                          g_tokens)
        return _next_token_loss(self.lm.forward_embeds(spliced), labels)


def parser():
    p = base_parser(__doc__.splitlines()[0], n_epoch=40, lr=0.003,
                    batch_size=16)
    p.add_argument("--template", choices=["nd", "ho"], default="nd")
    return p


def llaga_batch(args, data):
    """The script's host inputs: (graph inputs (numpy), input ids, labels,
    K graph tokens a prompt)."""
    rng = np.random.default_rng(args.seed)
    x = np.asarray(data["x"])[:, :16].astype(np.float32)
    ei = np.asarray(data["edge_index"])
    y = np.asarray(data["y"])
    n = x.shape[0]
    nodes = rng.permutation(n)[:args.batch_size]
    s, h = 3, 2
    if args.template == "nd":
        seq = llaga_neighborhood_detail(ei, nodes, n, use_hop=h,
                                        sample_size=s, seed=args.seed)
        K = seq.shape[1] + h + 2   # node slots + hop separators
        graph_inputs = (seq, x)
    else:
        graph_inputs = llaga_hop_field(x, ei, nodes, num_hops=h)
        K = h + 1
    max_len = 96
    ids = np.zeros((len(nodes), max_len), np.int32)
    labels = np.full((len(nodes), max_len), IGNORE_INDEX, np.int32)
    for b, v in enumerate(nodes):
        conv = get_conv_template("llaga_llama_2")
        conv.append_message(conv.roles[0],
                            f"Node {DEFAULT_GRAPH_TOKEN} category?")
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()[-40:]
        pre, _, post = prompt.partition(DEFAULT_GRAPH_TOKEN)
        seq_ids = (toy_tokenizer(pre) + [GRAPH_TOKEN_INDEX] * K
                   + toy_tokenizer(post))
        resp = toy_tokenizer(f"class {y[v]}")
        lab = [IGNORE_INDEX] * len(seq_ids) + resp
        seq_ids = (seq_ids + resp)[:max_len]
        ids[b, :len(seq_ids)] = seq_ids
        labels[b, :len(lab[:max_len])] = lab[:max_len]
    return graph_inputs, ids, labels, K


def main(args, data=None, params=None):
    """Tune; returns {"losses", "step_ms", "state", "inputs"}.
    ``params``: a flax tree of `LLaGAModel` (None: its own init)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    graph_inputs, ids, labels, K = llaga_batch(args, data)
    width = (graph_inputs[1] if args.template == "nd"
             else graph_inputs).shape[-1]

    def put(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    graph_inputs = (tuple(put(a) for a in graph_inputs)
                    if args.template == "nd" else put(graph_inputs))
    torch.manual_seed(args.seed)
    model = LLaGAModel(K, template=args.template, use_hop=2, sample_size=3,
                       in_channels=width)
    if params is not None:
        load_jax_params(model, params)
    model = model.to(dev)
    inputs = (graph_inputs, put(ids), put(labels))
    state = TrainState(model, args.lr)
    losses, step_ms = [], []
    for epoch in range(args.n_epoch):
        t0 = time.perf_counter()
        loss = model(*inputs)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if epoch % 10 == 0 or epoch == args.n_epoch - 1:
            print(f"epoch {epoch:3d} [{args.template}] "
                  f"instruction CE {losses[-1]:.4f}")
    return {"losses": losses, "step_ms": step_ms, "state": state,
            "inputs": inputs}


if __name__ == "__main__":
    main(parser().parse_args())
