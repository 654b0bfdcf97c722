"""flax's ``Dense`` on an ``nn.Linear``, and flax's initialisers.

The port's layers keep their linear maps as ``nn.Linear`` modules (so
`load_jax_params` can carry a flax ``kernel`` across, transposed) and apply
them through `dense`, which follows flax's dtype rule and its lazy
in-features.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

__all__ = ["dense", "dropout", "glorot_uniform_", "fan_in_normal_",
           "lecun_normal_", "lecun_linear_", "lecun_dense", "lecun_apply",
           "glorot_dense"]


def glorot_uniform_(t):
    """flax's ``glorot_uniform``: fan_in the second-to-last dimension,
    fan_out the last, both times the product of the leading ones. The limit
    is symmetric in the two fans, so an (out, in) ``nn.Linear`` weight, the
    transpose of a flax kernel, draws from the same law."""
    receptive = t[..., 0, 0].numel()
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-lim, lim)


def fan_in_normal_(weight, scale, fan_in=None):
    """flax's truncated-normal ``variance_scaling(scale, "fan_in")`` on an
    (out, in) weight: a unit normal cut at +-2, scaled to variance
    scale / in (``fan_in`` when given: a kernel of another layout).
    ``he_normal`` is scale 2, ``lecun_normal`` (the default ``Dense``
    kernel) scale 1."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0).mul_(std)


def lecun_normal_(weight):
    """flax's default ``Dense`` kernel init."""
    return fan_in_normal_(weight, 1.0)


def lecun_linear_(lin):
    """flax's default ``Dense`` init on an ``nn.Linear``: a lecun-normal
    kernel and a zero bias. A lazy layer is left to `dense`, which draws
    at first use. Returns ``lin``."""
    if not isinstance(lin.weight, UninitializedParameter):
        lecun_normal_(lin.weight)
        if lin.bias is not None:
            nn.init.zeros_(lin.bias)
    return lin


def lecun_dense(in_channels, out_channels, bias=True):
    """A flax default ``Dense`` as an ``nn.Linear``: lecun-normal kernel,
    zero bias; lazy when ``in_channels`` is None (`dense` draws it at
    first use)."""
    return lecun_linear_(
        nn.LazyLinear(out_channels, bias=bias) if in_channels is None
        else nn.Linear(in_channels, out_channels, bias=bias))


def lecun_apply(lin, x):
    """A flax default ``Dense`` of ``x`` (a lazy ``lin`` draws lecun-normal
    at first use)."""
    return dense(lin, x, None, lecun_normal_)


def glorot_dense(in_channels, out_channels, bias=True):
    """A ``Dense`` with flax's glorot-uniform kernel and zero bias, lazy
    when ``in_channels`` is None (apply it with `dense(..., glorot_uniform_)`
    so a lazy one draws the same law)."""
    if in_channels is None:
        return nn.LazyLinear(out_channels, bias=bias)
    lin = nn.Linear(in_channels, out_channels, bias=bias)
    glorot_uniform_(lin.weight)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def dense(lin, x, dtype, init):
    """flax ``Dense(dtype=dtype)`` of ``x`` with ``lin``'s parameters.

    A lazy ``lin`` first takes its in-features from ``x`` (and, when its
    out-features are 0, those too: a square map), draws its weight with
    ``init`` and zeroes its bias. ``x`` and the parameters are cast to
    ``dtype``; None promotes x's dtype and the weight's, as flax does.
    """
    if isinstance(lin.weight, UninitializedParameter):
        out = lin.out_features or x.shape[-1]
        with torch.inference_mode(False), torch.no_grad():
            lin.weight.materialize((out, x.shape[-1]))
            init(lin.weight)
            if lin.bias is not None:
                lin.bias.materialize((out,))
                lin.bias.zero_()
        lin.in_features, lin.out_features = x.shape[-1], out
    if dtype is None:
        dtype = torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def dropout(x, rate, generator=None):
    """flax's ``nn.Dropout`` in training mode: each entry of ``x`` kept
    with probability 1 - rate and scaled by 1/(1 - rate). The draw comes
    from ``generator`` on the generator's own device (None: x's device's
    default generator), so one generator state gives every path the same
    mask."""
    if rate == 0:
        return x
    device = generator.device if generator is not None else x.device
    kept = (torch.rand(x.shape, generator=generator, device=device)
            >= rate).to(x.device)
    return torch.where(kept, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
