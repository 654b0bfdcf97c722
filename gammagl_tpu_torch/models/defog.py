"""DeFoG: discrete flow matching for graph generation (Qin et al. 2025)
(counterpart of `gammagl_tpu/models/defog.py`).

Reference: gammagl/models/defog.py:1-206 (graph-transformer denoiser over
dense (X, E, y) with FiLM conditioning between the node, edge and global
streams; XEyTransformerLayer from gammagl/layers/attention/defog_layer.py:267)
and examples/defog/flow_matching.py (linear-interpolation noising of
categorical node and edge types, Euler sampling toward the predicted clean
distribution).

Dense tensors, one graph (no batch axis): X (N, dX), E (N, N, dE), y (dy,).

The noising and the sampler step are each split into their random draws
(`flow_draws`, `euler_draws`, from a `torch.Generator`) and a pure
function of those draws (`flow_interpolate_apply`, `euler_apply`). The
JAX package draws its keep and resample masks from one key each
(`jax.random.bernoulli` and `randint` / `categorical` on the same ``kx``,
the same ``ke``), so its two draws are correlated; the port draws them
independently. The pure parts are the JAX package's to the bit: handed
JAX's draws they give its outputs.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense

__all__ = ["DeFoGModel", "XEyTransformerLayer", "timestep_embedding",
           "flow_interpolate", "euler_sample_step", "flow_draws",
           "flow_interpolate_apply", "euler_draws", "euler_apply"]


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal timestep embedding (reference
    defog.py:_timestep_embedding): (T, dim) float32, cosines then sines,
    a zero column appended when ``dim`` is odd."""
    t = torch.as_tensor(t)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.reshape(-1, 1).float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _ln(width):
    return nn.LayerNorm(width, eps=1e-6)  # flax's LayerNorm epsilon


class XEyTransformerLayer(nn.Module):
    """Node/edge/global co-attention block (reference defog_layer.py:267):
    self-attention over nodes whose logits the edge features modulate
    (FiLM), an edge stream updated from the pre-softmax logits, and a
    global stream y that conditions both (FiLM) and is updated from their
    means. flax names ``Dense_0`` ... ``Dense_14``, ``LayerNorm_0`` ...
    ``LayerNorm_2`` in the JAX module's creation order."""

    def __init__(self, dx, de, dy, n_head):
        super().__init__()
        self.H, self.D = n_head, dx // n_head
        hd = self.H * self.D
        shapes = [(dx, hd), (dx, hd), (dx, hd),      # q, k, v
                  (de, n_head), (de, n_head),        # E FiLM of logits
                  (n_head, de),                      # new E
                  (dy, de), (dy, de),                # y FiLM of new E
                  (de, de),                          # E out
                  (dy, dx), (dy, dx),                # y FiLM of nodes
                  (hd, dx),                          # X out
                  (dy, dy), (dx, dy), (de, dy)]      # y update
        self.lins = nn.ModuleList(lecun_dense(a, b) for a, b in shapes)
        self.norms = nn.ModuleList([_ln(de), _ln(dx), _ln(dy)])

    def flax_tree(self):
        tree = {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}
        tree.update({f"LayerNorm_{i}": n for i, n in enumerate(self.norms)})
        return tree

    def forward(self, X, E, y, node_mask=None):
        d = [lambda v, lin=lin: lecun_apply(lin, v) for lin in self.lins]
        H, D, N = self.H, self.D, X.shape[0]
        q = d[0](X).reshape(N, H, D)
        k = d[1](X).reshape(N, H, D)
        v = d[2](X).reshape(N, H, D)
        scores = torch.einsum("nhd,mhd->nmh", q, k) / math.sqrt(D)
        scores = scores * (d[3](E) + 1) + d[4](E)
        newE = d[5](scores)
        newE = newE * (d[6](y) + 1) + d[7](y)
        E_out = self.norms[0](E + d[8](F.relu(newE)))

        if node_mask is not None:
            scores = torch.where(node_mask[None, :, None], scores,
                                 torch.full((), -1e9, dtype=scores.dtype,
                                            device=scores.device))
        attn = torch.softmax(scores, dim=1)
        out = torch.einsum("nmh,mhd->nhd", attn, v).reshape(N, H * D)
        out = out * (d[9](y) + 1) + d[10](y)
        X_out = self.norms[1](X + d[11](F.relu(out)))

        y_new = d[12](y) + d[13](X_out.mean(0)) + d[14](E_out.mean((0, 1)))
        y_out = self.norms[2](y + F.relu(y_new))
        return X_out, E_out, y_out


class DeFoGModel(nn.Module):
    """Graph-transformer denoiser: (noisy X, E, y, t) -> clean logits
    (X (N, dX), E (N, N, dE) symmetric, y). y is extended by a 64-wide
    embedding of t, so ``input_dims["y"]`` counts those 64 too."""

    def __init__(self, n_layers, input_dims, hidden_mlp_dims, hidden_dims,
                 output_dims):
        super().__init__()
        hm, hd, o = hidden_mlp_dims, hidden_dims, output_dims
        shapes = [(input_dims["X"], hm["X"]), (hm["X"], hd["dx"]),
                  (input_dims["E"], hm["E"]), (hm["E"], hd["de"]),
                  (input_dims["y"], hm["y"]), (hm["y"], hd["dy"]),
                  (hm["X"], o["X"]), (hd["dx"], hm["X"]),
                  (hm["E"], o["E"]), (hd["de"], hm["E"]),
                  (hd["dy"], o["y"])]
        self.lins = nn.ModuleList(lecun_dense(a, b) for a, b in shapes)
        self.layers = nn.ModuleList(
            XEyTransformerLayer(hd["dx"], hd["de"], hd["dy"], hd["n_head"])
            for _ in range(n_layers))

    def flax_tree(self):
        tree = {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}
        tree.update({f"XEyTransformerLayer_{i}": layer
                     for i, layer in enumerate(self.layers)})
        return tree

    def forward(self, X, E, y, t, node_mask=None):
        """X: (N, dX) one-hot-ish node types; E: (N, N, dE); y: (dy,);
        t: scalar time in [0, 1]."""
        d = [lambda v, lin=lin: lecun_apply(lin, v) for lin in self.lins]
        t_emb = timestep_embedding(torch.as_tensor(t, device=X.device), 64)[0]
        y = torch.cat([torch.atleast_1d(torch.as_tensor(
            y, device=X.device)).reshape(-1).float(), t_emb])

        h_X = F.relu(d[1](F.relu(d[0](X))))
        E_sym = (E + E.transpose(0, 1)) / 2
        h_E = F.relu(d[3](F.relu(d[2](E_sym))))
        h_y = F.relu(d[5](F.relu(d[4](y))))
        for layer in self.layers:
            h_X, h_E, h_y = layer(h_X, h_E, h_y, node_mask)

        out_X = d[6](F.relu(d[7](h_X)))
        out_E = d[8](F.relu(d[9](h_E)))
        out_E = (out_E + out_E.transpose(0, 1)) / 2
        out_y = d[10](h_y)
        return out_X, out_E, out_y


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def flow_draws(generator, N, dX, dE, t, device=None):
    """The draws of one noising: ``keep_x`` (N,) and ``keep_e`` (N, N)
    bools, each True with probability t; ``rand_x`` (N,) and ``rand_e``
    (N, N) uniform class ids. Drawn independently from ``generator``
    (on its device, or ``device``)."""
    device = device if device is not None else generator.device
    t = torch.as_tensor(t, device=device)
    return {"keep_x": _uniform((N,), generator, device) < t,
            "rand_x": torch.randint(0, dX, (N,), generator=generator,
                                    device=device),
            "keep_e": _uniform((N, N), generator, device) < t,
            "rand_e": torch.randint(0, dE, (N, N), generator=generator,
                                    device=device)}


def flow_interpolate_apply(draws, X0, E0):
    """The noising on given draws: a node keeps its one-hot X0 row where
    ``keep_x``, else takes class ``rand_x``. The edge keep mask is made
    symmetric from its upper triangle, ``triu(k) | triu(k, 1).T``; the
    resampled edges are (one_hot(rand_e) + its transpose) / 2, which
    leaves half-weights where the two one-hots differ, as in the JAX
    package."""
    dX, dE = X0.shape[1], E0.shape[-1]
    rand_x = F.one_hot(draws["rand_x"].long(), dX).to(X0.dtype)
    Xt = torch.where(draws["keep_x"][:, None], X0, rand_x)
    keep = draws["keep_e"].bool()
    keep_e = torch.triu(keep) | torch.triu(keep, 1).T
    rand_e = F.one_hot(draws["rand_e"].long(), dE).to(E0.dtype)
    rand_e = (rand_e + rand_e.transpose(0, 1)) / 2
    Et = torch.where(keep_e[..., None], E0, rand_e)
    return Xt, Et


def flow_interpolate(generator, X0, E0, t):
    """Discrete flow noising (reference examples/defog/flow_matching.py):
    with probability (1 - t) resample each categorical entry uniformly;
    t = 1 is the clean graph, t = 0 pure noise. X0 (N, dX), E0 (N, N, dE)
    one-hot. ``generator`` is a `torch.Generator` on X0's device."""
    N, dX = X0.shape
    draws = flow_draws(generator, N, dX, E0.shape[-1], t, X0.device)
    return flow_interpolate_apply(draws, X0, E0)


def euler_draws(generator, pred_X_logits, pred_E_logits, t, dt):
    """The draws of one Euler step: class ids from the predicted logits
    (``new_x`` (N,), ``new_e`` (N, N); Gumbel-max) and the jump masks
    ``jump_x`` (N,), ``jump_e`` (N, N), each True with probability
    clip(dt / max(1 - t, dt), 0, 1)."""
    dev = pred_X_logits.device
    N = pred_X_logits.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    jump_p = torch.clamp(dt / torch.maximum(1 - t, dt), 0.0, 1.0)

    def categorical(logits):
        g = -torch.log(-torch.log(_uniform(logits.shape, generator, dev)))
        return torch.argmax(logits + g, -1)

    return {"new_x": categorical(pred_X_logits),
            "jump_x": _uniform((N,), generator, dev) < jump_p,
            "new_e": categorical(pred_E_logits),
            "jump_e": _uniform((N, N), generator, dev) < jump_p}


def euler_apply(draws, Xt, Et):
    """The Euler step on given draws: nodes where ``jump_x`` take class
    ``new_x``; the edge classes are made symmetric as
    ``triu(new_e) + triu(new_e, 1).T`` (integer sums), the jump mask as
    ``triu(j) | triu(j, 1).T``, and edges where it holds take those
    classes."""
    dX, dE = Xt.shape[1], Et.shape[-1]
    new_x = F.one_hot(draws["new_x"].long(), dX).to(Xt.dtype)
    Xn = torch.where(draws["jump_x"][:, None], new_x, Xt)
    idx = draws["new_e"].long()
    idx = torch.triu(idx) + torch.triu(idx, 1).T
    new_e = F.one_hot(idx, dE).to(Et.dtype)
    jump = draws["jump_e"].bool()
    jump_e = torch.triu(jump) | torch.triu(jump, 1).T
    En = torch.where(jump_e[..., None], new_e, Et)
    return Xn, En


def euler_sample_step(generator, Xt, Et, pred_X_logits, pred_E_logits, t,
                      dt):
    """One Euler step of the CTMC sampler toward the predicted clean
    distribution (reference examples/defog/sampler.py): jump to a sample
    of p(clean) with probability dt / (1 - t)."""
    draws = euler_draws(generator, pred_X_logits, pred_E_logits, t, dt)
    return euler_apply(draws, Xt, Et)
