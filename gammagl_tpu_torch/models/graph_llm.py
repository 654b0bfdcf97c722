"""Graph-LLM models: GraphGPT-style CLIP pretraining and graph-token
splicing, LLaGA's node-sequence templates (counterparts of
`gammagl_tpu/models/graph_llm.py`; reference: gammagl/models/graphgpt.py
and llaga.py).

The language model is decoupled, as in JAX: these modules make graph
embeddings and splice them into the input embeddings of any model that
exposes a token-embedding lookup and a forward over embeddings
(`TinyCausalLM` here, a `transformers` Llama in its place).

flax's defaults are kept where PyTorch's differ: LayerNorm's epsilon is
1e-6, GELU is the tanh approximation, and the self-attention is flax's
``SelfAttention`` (`spectral._SelfAttention`: queries scaled by
1/sqrt(head dim) before the product, masked scores filled with the
dtype's finfo min, not -inf). The GCNs run the COO route, as the JAX
layers run without a plan. The sentinels are negative (`GRAPH_TOKEN_INDEX`
-200, `IGNORE_INDEX` -100, `DEFAULT_GRAPH_PAD_ID` -500): every gather
clamps them into range first, as JAX clamps, and the result is masked.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.models.spectral import _SelfAttention
from gammagl_tpu_torch.utils.gfm_utils import (DEFAULT_GRAPH_PAD_ID,
                                               DEFAULT_GRAPH_TOKEN,
                                               GRAPH_TOKEN_INDEX,
                                               IGNORE_INDEX)

__all__ = ["GraphTextCLIP", "GraphLlamaAdapter", "LLaGAEncoder",
           "splice_graph_embeddings", "TinyCausalLM", "GraphLlamaLM",
           "build_stage2_batch", "llaga_hop_field",
           "llaga_neighborhood_detail", "LLaGAProjector"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _layer_norm(width):
    return nn.LayerNorm(width, eps=1e-6)


def _embedding(num, width, std):
    emb = nn.Embedding(num, width)
    nn.init.normal_(emb.weight, std=std)
    return emb


def _causal_mask(length, device):
    """flax's ``make_causal_mask``: (1, L, L), True at key <= query."""
    return torch.ones(length, length, dtype=torch.bool,
                      device=device).tril()[None]


def _next_token_loss(logits, labels):
    """optax's softmax cross-entropy of each position's logits against the
    next label, masked to labels that are not `IGNORE_INDEX`, averaged
    over them (at least one)."""
    tgt, lg = labels[:, 1:], logits[:, :-1]
    keep = (tgt != IGNORE_INDEX).float()
    ls = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                         tgt.clamp_min(0).reshape(-1).long(),
                         reduction="none").view(tgt.shape)
    return (ls * keep).sum() / keep.sum().clamp_min(1.0)


class _TextTransformer(nn.Module):
    """The CLIP text tower: token embedding (flax ``Embed_0``) plus
    ``positional_embedding``, ``layers`` pre-norm blocks of causal
    self-attention and a 4x GELU feed-forward, and a final norm. flax
    names its parts in construction order: in block i ``LayerNorm_{2i}``
    and ``SelfAttention_i``, then the feed-forward's outer map
    ``Dense_{2i}`` (4w -> w), built before its inner ``Dense_{2i+1}``
    (w -> 4w), and ``LayerNorm_{2i+1}``; the final norm is
    ``LayerNorm_{2 layers}``."""

    def __init__(self, width, layers, heads, vocab_size, context_length):
        super().__init__()
        self.embed = _embedding(vocab_size, width, 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width) * 0.01)
        self.attn = nn.ModuleList(_SelfAttention(width, heads)
                                  for _ in range(layers))
        self.norms = nn.ModuleList(_layer_norm(width)
                                   for _ in range(2 * layers + 1))
        self.up = nn.ModuleList(lecun_dense(width, 4 * width)
                                for _ in range(layers))
        self.down = nn.ModuleList(lecun_dense(4 * width, width)
                                  for _ in range(layers))

    def flax_tree(self):
        tree = {"Embed_0": self.embed,
                "positional_embedding": self.positional_embedding}
        for i, norm in enumerate(self.norms):
            tree[f"LayerNorm_{i}"] = norm
        for i, attn in enumerate(self.attn):
            tree[f"SelfAttention_{i}"] = attn
            tree[f"Dense_{2 * i}"] = self.down[i]
            tree[f"Dense_{2 * i + 1}"] = self.up[i]
        return tree

    def forward(self, token_ids):
        L = token_ids.shape[1]
        h = self.embed(token_ids) + self.positional_embedding[None, :L]
        mask = _causal_mask(L, h.device)
        for i, attn in enumerate(self.attn):
            h = h + attn(self.norms[2 * i](h), mask=mask)
            h = h + self.down[i](_gelu(self.up[i](self.norms[2 * i + 1](h))))
        return self.norms[-1](h)


class GraphTextCLIP(nn.Module):
    """CLIP-style graph-text contrastive pretraining (reference
    graphgpt.py:178): two GCNConvs give node embeddings, the text tower
    embeds each description at its last token (times
    ``text_projection``), and a symmetric InfoNCE at temperature ``tau``
    aligns the pairs. flax names ``GCNConv_0``, ``GCNConv_1``,
    ``_TextTransformer_0``, ``text_projection``."""

    def __init__(self, embed_dim=128, gnn_hidden=128, transformer_width=128,
                 transformer_layers=2, transformer_heads=4, vocab_size=32000,
                 context_length=64, tau=0.07, in_channels=None):
        super().__init__()
        self.tau = tau
        self.gnn = nn.ModuleList([GCNConv(in_channels, gnn_hidden),
                                  GCNConv(gnn_hidden, embed_dim)])
        self.text = _TextTransformer(transformer_width, transformer_layers,
                                     transformer_heads, vocab_size,
                                     context_length)
        self.text_projection = nn.Parameter(
            torch.randn(transformer_width, embed_dim)
            * transformer_width ** -0.5)

    def flax_tree(self):
        return {"GCNConv_0": self.gnn[0], "GCNConv_1": self.gnn[1],
                "_TextTransformer_0": self.text,
                "text_projection": self.text_projection}

    def forward(self, x, edge_index, node_ids, token_ids, num_nodes=None):
        """node_ids (B,) nodes paired with the descriptions token_ids (B,
        L). Returns (loss, (node embeddings, text embeddings))."""
        h = F.relu(self.gnn[0](x, edge_index, num_nodes=num_nodes))
        h = self.gnn[1](h, edge_index, num_nodes=num_nodes)
        g_emb = h[node_ids.long()]
        t_emb = self.text(token_ids)[:, -1] @ self.text_projection
        g = g_emb / (g_emb.norm(dim=-1, keepdim=True) + 1e-8)
        t = t_emb / (t_emb.norm(dim=-1, keepdim=True) + 1e-8)
        logits = g @ t.T / self.tau
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = (F.cross_entropy(logits, labels)
                + F.cross_entropy(logits.T, labels)) / 2
        return loss, (g_emb, t_emb)


class GraphLlamaAdapter(nn.Module):
    """Graph encoder and projector into a language model's hidden space
    (reference GraphLlamaModel.graph_projector :543): two GCNConvs of
    ``graph_hidden_size`` (ReLU between) and ``graph_projector``."""

    def __init__(self, lm_hidden_size, graph_hidden_size=128,
                 in_channels=None):
        super().__init__()
        self.convs = nn.ModuleList([
            GCNConv(in_channels, graph_hidden_size),
            GCNConv(graph_hidden_size, graph_hidden_size)])
        self.graph_projector = lecun_dense(graph_hidden_size, lm_hidden_size)

    def flax_tree(self):
        return {"GCNConv_0": self.convs[0], "GCNConv_1": self.convs[1],
                "graph_projector": self.graph_projector}

    def forward(self, x, edge_index, num_nodes=None):
        h = F.relu(self.convs[0](x, edge_index, num_nodes=num_nodes))
        h = self.convs[1](h, edge_index, num_nodes=num_nodes)
        return self.graph_projector(h)


class LLaGAEncoder(nn.Module):
    """LLaGA's hop-field encoder (Chen 2024; reference llaga.py): each of
    a node's per-hop mean features (B, num_hops + 1, F) mapped to 2H,
    GELU, then to the hidden size H: one token a hop. flax names
    ``Dense_0``, ``Dense_1``."""

    def __init__(self, lm_hidden_size, num_hops=2, sample_size=10,
                 in_channels=None):
        super().__init__()
        self.num_hops, self.sample_size = num_hops, sample_size
        self.lin0 = lecun_dense(in_channels, 2 * lm_hidden_size)
        self.lin1 = lecun_dense(2 * lm_hidden_size, lm_hidden_size)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1}

    def forward(self, hop_features):
        return self.lin1(_gelu(lecun_apply(self.lin0, hop_features)))


def splice_graph_embeddings(input_ids, token_embeds, graph_embeds,
                            graph_token_index=GRAPH_TOKEN_INDEX):
    """Replace the sentinel positions of a token sequence with graph
    embeddings, in order (reference GraphLlamaModel.forward :582).

    input_ids (L,) with k sentinels, token_embeds (L, H), graph_embeds
    (k, H); or a batch of each, (B, L), (B, L, H), (B, k, H). A position
    past the k-th sentinel reads the last graph embedding, as JAX clips
    the slot (the result there is the token's own embedding anyway)."""
    is_graph = input_ids == graph_token_index
    slot = (torch.cumsum(is_graph.long(), dim=-1) - 1).clamp(
        0, graph_embeds.shape[-2] - 1)
    picked = torch.take_along_dim(graph_embeds, slot[..., None], dim=-2)
    return torch.where(is_graph[..., None], picked, token_embeds)


class TinyCausalLM(nn.Module):
    """A small causal language model with a tied embedding head: the test
    and demo backbone of the GraphGPT / LLaGA stage-2 path (a real Llama
    exposes the same two surfaces, `embed` and `forward_embeds`). flax
    names ``tok``, ``pos``, ``blocks_{i}_{ln1,attn,ln2,up,down}``,
    ``ln_f``."""

    def __init__(self, vocab_size=512, hidden=64, layers=2, heads=4,
                 max_len=128):
        super().__init__()
        self.tok = _embedding(vocab_size, hidden, 0.02)
        self.pos = nn.Parameter(torch.randn(max_len, hidden) * 0.01)
        self.blocks = nn.ModuleList(nn.ModuleDict({
            "ln1": _layer_norm(hidden),
            "attn": _SelfAttention(hidden, heads),
            "ln2": _layer_norm(hidden),
            "up": lecun_dense(hidden, 4 * hidden),
            "down": lecun_dense(4 * hidden, hidden)})
            for _ in range(layers))
        self.ln_f = _layer_norm(hidden)

    def flax_tree(self):
        tree = {"tok": self.tok, "pos": self.pos, "ln_f": self.ln_f}
        for i, blk in enumerate(self.blocks):
            for name, part in blk.items():
                tree[f"blocks_{i}_{name}"] = part
        return tree

    def embed(self, input_ids):
        """The token-embedding lookup (clip sentinels out first)."""
        return self.tok(input_ids.long())

    def forward_embeds(self, h):
        """(B, L, H) input embeddings -> (B, L, V) logits; causal."""
        L = h.shape[1]
        h = h + self.pos[None, :L]
        mask = _causal_mask(L, h.device)
        for blk in self.blocks:
            h = h + blk["attn"](blk["ln1"](h), mask=mask)
            h = h + blk["down"](_gelu(blk["up"](blk["ln2"](h))))
        return self.ln_f(h) @ self.tok.weight.T

    def forward(self, input_ids):
        return self.forward_embeds(self.embed(input_ids))


class GraphLlamaLM(nn.Module):
    """GraphGPT's stage-2 model (reference graphgpt.py
    GraphLlamaModel.forward:582): the graph-token sentinels of each prompt
    are replaced by the adapter's embeddings of the given nodes before the
    language model runs; cross-entropy on the response tokens only.

    ``forward(x, edge_index, node_ids, input_ids, labels)``: node_ids
    (B, K) nodes whose embeddings fill the K sentinels of each row of
    input_ids (B, L); labels (B, L) with `IGNORE_INDEX` on prompt, pad and
    graph positions. Returns the logits, or with labels (loss, logits).
    flax names ``lm``, ``adapter``."""

    def __init__(self, vocab_size=512, lm_hidden=64, graph_hidden=64,
                 lm_layers=2, max_len=128, in_channels=None):
        super().__init__()
        self.lm = TinyCausalLM(vocab_size=vocab_size, hidden=lm_hidden,
                               layers=lm_layers, max_len=max_len)
        self.adapter = GraphLlamaAdapter(lm_hidden_size=lm_hidden,
                                         graph_hidden_size=graph_hidden,
                                         in_channels=in_channels)

    def flax_tree(self):
        return {"lm": self.lm, "adapter": self.adapter}

    def forward(self, x, edge_index, node_ids, input_ids, labels=None,
                num_nodes=None):
        g_emb = self.adapter(x, edge_index, num_nodes=num_nodes)   # (N, H)
        safe = torch.where(input_ids == GRAPH_TOKEN_INDEX, 0, input_ids)
        tok = self.lm.embed(safe)                                  # (B, L, H)
        nid = node_ids.long().clamp(0, g_emb.shape[0] - 1)
        logits = self.lm.forward_embeds(
            splice_graph_embeddings(input_ids, tok, g_emb[nid]))
        if labels is None:
            return logits
        return _next_token_loss(logits, labels), logits


def build_stage2_batch(prompts, responses, tokenizer, num_graph_tokens,
                       max_len):
    """Host-side tokenize and pad for the stage-2 splice path (reference
    graphgpt's stage-2 collator): each prompt's one ``<graph>``
    placeholder expands to ``num_graph_tokens`` sentinels; labels are
    `IGNORE_INDEX` on prompt, graph and pad positions and the token ids on
    the response. Returns (input_ids, labels), int32 (B, max_len)."""
    B = len(prompts)
    ids = np.zeros((B, max_len), np.int32)
    labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
    for b, (p, r) in enumerate(zip(prompts, responses)):
        pre, _, post = p.partition(DEFAULT_GRAPH_TOKEN)
        seq = (tokenizer(pre)
               + [GRAPH_TOKEN_INDEX] * num_graph_tokens
               + tokenizer(post))
        resp = tokenizer(r)
        lab = [IGNORE_INDEX] * len(seq) + resp
        seq = (seq + resp)[:max_len]
        lab = lab[:max_len]
        ids[b, :len(seq)] = seq
        labels[b, :len(lab)] = lab
    return ids, labels


# -- LLaGA structure-aware templates (reference llaga.py) ----------------

def llaga_hop_field(x, edge_index, nodes, num_hops=2):
    """Hop-field (HO) template: per target node, the mean features of each
    hop ring 0..num_hops, (B, num_hops + 1, F) float32 (host numpy; read
    by `LLaGAEncoder`)."""
    x = np.asarray(x)
    ei = np.asarray(edge_index)
    n = x.shape[0]
    adj = [[] for _ in range(n)]
    for s, d in ei.T:
        adj[int(d)].append(int(s))
    out = np.zeros((len(nodes), num_hops + 1, x.shape[1]), np.float32)
    for b, v in enumerate(np.asarray(nodes)):
        frontier = {int(v)}
        seen = {int(v)}
        out[b, 0] = x[int(v)]
        for hop in range(1, num_hops + 1):
            nxt = set()
            for u in frontier:
                nxt.update(adj[u])
            nxt -= seen
            if nxt:
                out[b, hop] = x[sorted(nxt)].mean(0)
            seen |= nxt
            frontier = nxt
    return out


def llaga_neighborhood_detail(edge_index, nodes, num_nodes, use_hop=2,
                              sample_size=3, seed=0):
    """Neighborhood-detail (ND) template: a fixed-shape sampled neighbour
    tree per target node, sample_size^i slots at hop i,
    (s^(h+1) - 1) / (s - 1) ids in all, missing slots
    `DEFAULT_GRAPH_PAD_ID` (reference llaga.py:99-101; host numpy, draws
    from ``np.random.default_rng(seed)``)."""
    ei = np.asarray(edge_index)
    rng = np.random.default_rng(seed)
    adj = [[] for _ in range(num_nodes)]
    for s, d in ei.T:
        adj[int(d)].append(int(s))
    total = (sample_size ** (use_hop + 1) - 1) // (sample_size - 1)
    out = np.full((len(np.asarray(nodes)), total), DEFAULT_GRAPH_PAD_ID,
                  np.int64)
    for b, v in enumerate(np.asarray(nodes)):
        layer = [int(v)]
        out[b, 0] = int(v)
        cur = 1
        for hop in range(1, use_hop + 1):
            nxt = []
            for u in layer:
                if u == DEFAULT_GRAPH_PAD_ID or not adj[u]:
                    nxt.extend([DEFAULT_GRAPH_PAD_ID] * sample_size)
                    continue
                nbrs = adj[u]
                pick = (rng.choice(nbrs, sample_size, replace=False)
                        if len(nbrs) >= sample_size
                        else np.concatenate([
                            nbrs, np.full(sample_size - len(nbrs),
                                          DEFAULT_GRAPH_PAD_ID)]))
                nxt.extend(int(p) for p in pick)
            out[b, cur:cur + len(nxt)] = nxt
            cur += len(nxt)
            layer = nxt
    return out


class LLaGAProjector(nn.Module):
    """The ND template's projector with hop-separator tokens (reference
    llaga.py `inject_special_token`:98-112): the sampled nodes' features
    mapped to 2H, GELU, to H (flax ``Dense_0``, ``Dense_1``), PAD slots
    zeroed, and use_hop + 2 learned ``special_token_emb`` rows around and
    between the hop groups."""

    def __init__(self, lm_hidden_size, use_hop=2, sample_size=3,
                 in_channels=None):
        super().__init__()
        self.use_hop, self.sample_size = use_hop, sample_size
        self.lin0 = lecun_dense(in_channels, 2 * lm_hidden_size)
        self.lin1 = lecun_dense(2 * lm_hidden_size, lm_hidden_size)
        self.special_token_emb = nn.Parameter(
            torch.randn(use_hop + 2, lm_hidden_size) * 0.02)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1,
                "special_token_emb": self.special_token_emb}

    def forward(self, node_seq, node_feats):
        """node_seq (B, T) ids with `DEFAULT_GRAPH_PAD_ID`; node_feats (N,
        F). Returns (B, T + use_hop + 2, H) graph tokens."""
        s, h = self.sample_size, self.use_hop
        total = (s ** (h + 1) - 1) // (s - 1)
        feats = node_feats[node_seq.long().clamp(0, node_feats.shape[0] - 1)]
        g = self.lin1(_gelu(lecun_apply(self.lin0, feats)))
        g = torch.where((node_seq == DEFAULT_GRAPH_PAD_ID)[..., None],
                        torch.zeros((), dtype=g.dtype, device=g.device), g)
        B = g.shape[0]
        special = self.special_token_emb
        parts = [special[0].expand(B, 1, -1)]
        cur = 0
        for i in range(h + 1):
            size = s ** i
            parts.append(g[:, cur:cur + size])
            cur += size
            parts.append(special[i + 1].expand(B, 1, -1))
        assert cur == total
        return torch.cat(parts, dim=1)
