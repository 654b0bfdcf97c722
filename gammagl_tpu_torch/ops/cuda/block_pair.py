"""Block-pair SpMM: the plan, the kernels' wrappers and the hybrid route.

PyTorch counterpart of `gammagl_tpu/ops/pallas/block_pair.py`. After a
bandwidth-reducing (`Graph.reorder_rcm`) or clustering
(`Graph.reorder_cluster`) order, each destination block of R rows draws
its sources from a few source blocks of S rows. The kernel of
``csrc/block_pair.cu`` stages each such (dst block, src block) pair's
source slab in shared memory (the next pair's streaming in while one is
summed) and adds every edge's row from there into per-row sums held in
registers, where the CSR kernel gathers one row of x per edge from
memory.

`spmm_block_pair` computes ``out[d] = sum_{(s, d)} w_sd * x[s]``. On a CUDA
tensor it launches the forward kernel (counted in
``spmm_block_pair.launches``) or raises; on a CPU tensor it runs the plain
version, `spmm_block_pair_reference`. It is differentiable once: the
gradient of ``x`` is the same kernel on the plan's transpose
(`BlockPairPlan.transpose`), the gradient of the weights the dw kernel
(`block_pair_dw`, counted in ``block_pair_dw.launches``), which writes each
edge's ``<g[dst_e], x[src_e]>`` to its slot in the caller's order. Weights
are read through the plan's ``w_perm`` inside the kernel: no gather or
scatter of them runs outside it. Both kernels are ``torch.library`` ops,
``gammagl::spmm_block_pair`` and ``gammagl::block_pair_dw``, whose
arguments are the plan's arrays and sizes.

`HybridPlan` splits a graph whose dense pairs hold only part of the edges:
those go to the block-pair kernel, the scattered tail to `spmm_csr`, and
the two partial sums are added.

The TPU layout (padded ET-edge tiles, one-hot matmuls, the f32 hi/lo split,
F padded to 128) does not carry over. `BlockPairPlan` keeps the JAX plan's
public sizes (``E_pad``, ``T``, ``fill_ratio``, ...), computed from the same
tiling, and lays its edges out for the card (see the class).
"""

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda._build import load_library
from gammagl_tpu_torch.ops.cuda.segment_matmul import (_KERNEL_DTYPES,
                                                       _bound, _check_x,
                                                       _first_order_only,
                                                       _pad_rows,
                                                       _placed_device,
                                                       _raise_on, _tracing,
                                                       build_csr_plan,
                                                       spmm_csr)
from gammagl_tpu_torch.parallel.halo import reorder_bandwidth

__all__ = ["BlockPairPlan", "build_block_pair_plan", "spmm_block_pair",
           "spmm_block_pair_reference", "block_pair_dw",
           "block_pair_dw_reference", "HybridPlan", "build_hybrid_plan",
           "spmm_hybrid"]

def _cdiv(a, b):
    return -(-a // b)


class BlockPairPlan:
    """Edges grouped by (dst block, src block) pair, built once on the host.

    Public sizes, as the JAX plan's: ``num_nodes``, ``num_src``,
    ``num_edges`` (the length of the caller's weight vector), ``R``, ``S``,
    ``ET``, ``nblocks``, ``n_src_blocks``, ``T`` (the TPU tiling's tile
    count: ceil(edges / ET) per pair plus one tile per destination block
    without edges), ``E_pad = T * ET``, ``fill_ratio`` (the plan's edges over
    ``E_pad``) and ``perm_nodes`` (the RCM order applied, or None).

    The card's layout, every array over the plan's edges in one order:
    grouped by destination block, then by source block, then sorted by
    destination row and source (a fixed order for every row's sum).

    row, col  : (E,) int32 destination and source of each edge
    w_perm    : (E,) int32 the caller's index of each edge: the kernel reads
                weights ``w[w_perm[e]]`` and writes the weight gradient there
    block_ptr : (nblocks + 1,) int64, the pairs of destination block b are
                [block_ptr[b], block_ptr[b + 1])
    pair_src  : (n_pairs,) int32 the source block of each pair, ascending
                within a destination block
    row_ptr   : (n_pairs * R + 1,) int32, the edges of row r of pair p's
                destination block are [row_ptr[p * R + r],
                row_ptr[p * R + r + 1]); a lane group of the kernel finds
                its rows' edges in each pair there. Its size, R entries a
                pair, is that of the JAX plan's ET slots a pair at the
                default R = ET

    One copy of the arrays is kept per device (`arrays`); the transpose
    plan of the backward is built on first use and kept too. While a trace
    runs neither cache is filled (as for `CSRPlan`).
    """

    def __init__(self, *, row, col, w_perm, block_ptr, pair_src, row_ptr,
                 num_nodes, num_src, num_edges, R, S, ET, T,
                 perm_nodes=None):
        self.row = row
        self.col = col
        self.w_perm = w_perm
        self.block_ptr = block_ptr
        self.pair_src = pair_src
        self.row_ptr = row_ptr
        self.num_nodes = int(num_nodes)
        self.num_src = int(num_src)
        self.num_edges = int(num_edges)
        self.R, self.S, self.ET = int(R), int(S), int(ET)
        self.T = int(T)
        self.E_pad = self.T * self.ET
        self.nblocks = _cdiv(self.num_nodes, self.R)
        self.n_src_blocks = _cdiv(self.num_src, self.S)
        self.fill_ratio = self.num_plan_edges / max(self.E_pad, 1)
        self.perm_nodes = perm_nodes
        # on a transpose plan: each edge's position in the forward plan, for
        # weights given in the forward plan's order
        self.fwd_pos = None
        self._placed = {}
        self._transpose = None

    @property
    def num_plan_edges(self):
        """The edges this plan holds (fewer than ``num_edges`` in a
        `HybridPlan`'s block-pair part)."""
        return int(self.col.shape[0])

    def transpose(self):
        """The plan of the reverse graph (sources become rows, R and S
        swap); its ``w_perm`` still indexes the caller's edges, and its
        ``fwd_pos`` gives each edge's position in this plan."""
        if self._transpose is not None:
            return self._transpose
        tp, order = _layout(self.row, self.col, self.w_perm, self.num_src,
                            self.num_nodes, self.S, self.R, self.ET)
        tp.num_edges = self.num_edges
        tp.fwd_pos = order.astype(np.int32)
        if not _tracing():
            self._transpose = tp
        return tp

    def arrays(self, device):
        """(row, col, w_perm, block_ptr, pair_src, row_ptr, fwd_pos) as
        tensors on ``device``, copied once (fwd_pos None on a forward
        plan); in a trace, the bound buffers (`buffers`) or copies for that
        trace alone."""
        device = _placed_device(device)
        if _tracing():
            bound = _bound(self)
            if bound is not None:
                return tuple(bound.get(name) for name in _BP_ARRAYS)
            return self._copies(device)
        placed = self._placed.get(device)
        if placed is None:
            # ordinary tensors even when first placed under inference mode
            with torch.inference_mode(False):
                placed = self._placed[device] = self._copies(device)
        return placed

    def _copies(self, device):
        return tuple(None if a is None else torch.from_numpy(a).to(device)
                     for a in (self.row, self.col, self.w_perm,
                               self.block_ptr, self.pair_src, self.row_ptr,
                               self.fwd_pos))

    def buffers(self, device):
        """The tensors of this plan that its op reads, by name, on
        ``device``, for an export wrapper to carry as buffers
        (`serve.export_forward`)."""
        return {name: t for name, t in zip(_BP_ARRAYS, self.arrays(device))
                if t is not None}

    def __repr__(self):
        return (f"BlockPairPlan(N={self.num_nodes}, E={self.num_edges}, "
                f"E_pad={self.E_pad}, R={self.R}, S={self.S}, "
                f"ET={self.ET}, T={self.T}, fill={self.fill_ratio:.2f})")


_BP_ARRAYS = ("row", "col", "w_perm", "block_ptr", "pair_src", "row_ptr",
              "fwd_pos")


def _layout(src, dst, eid, num_nodes, num_src, R, S, ET):
    """The plan of edges (src, dst) whose caller indices are ``eid``;
    returns (plan, order), ``order`` the input position of each plan
    edge."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    eid = np.asarray(eid, np.int64).reshape(-1)
    num_nodes, num_src = int(num_nodes), int(num_src)
    R, S, ET = int(R), int(S), int(ET)
    if min(R, S, ET) < 1:
        raise ValueError(f"R, S and ET must be positive, got {R}, {S}, {ET}")
    if max(num_nodes, num_src, src.shape[0]) >= 2 ** 31:
        raise ValueError("the plan's int32 arrays cannot hold this graph")
    E = int(src.shape[0])
    if E:
        if int(dst.min()) < 0 or int(dst.max()) >= num_nodes:
            raise ValueError(
                f"build_block_pair_plan: dst out of range [0, {num_nodes}) "
                f"(min {int(dst.min())}, max {int(dst.max())})")
        if int(src.min()) < 0 or int(src.max()) >= num_src:
            raise ValueError(
                f"build_block_pair_plan: src out of range [0, {num_src}) "
                f"(min {int(src.min())}, max {int(src.max())})")
    nblocks = _cdiv(num_nodes, R)
    nsb = max(_cdiv(num_src, S), 1)
    db, sb = dst // R, src // S
    order = np.lexsort((src, dst, sb, db))  # block, src block, row, source
    pair_key = db[order] * nsb + sb[order]
    uniq, counts = np.unique(pair_key, return_counts=True)
    pair_db = uniq // nsb
    block_ptr = np.zeros(nblocks + 1, np.int64)
    np.cumsum(np.bincount(pair_db, minlength=nblocks), out=block_ptr[1:])
    n_pairs = int(uniq.shape[0])
    slot = (np.repeat(np.arange(n_pairs, dtype=np.int64), counts) * R
            + dst[order] - db[order] * R)
    row_ptr = np.zeros(n_pairs * R + 1, np.int32)
    np.cumsum(np.bincount(slot, minlength=n_pairs * R), out=row_ptr[1:])
    # the TPU tiling's size: ceil(edges / ET) tiles a pair, one tile for
    # each destination block without edges
    T = int(_cdiv(counts, ET).sum()) + nblocks - int(np.unique(pair_db).size)
    plan = BlockPairPlan(
        row=dst[order].astype(np.int32), col=src[order].astype(np.int32),
        w_perm=eid[order].astype(np.int32), block_ptr=block_ptr,
        pair_src=(uniq % nsb).astype(np.int32), row_ptr=row_ptr,
        num_nodes=num_nodes, num_src=num_src, num_edges=E, R=R, S=S, ET=ET,
        T=T)
    return plan, order


def build_block_pair_plan(src, dst, num_nodes, num_src=None, R=256, S=256,
                          ET=256, reorder=False):
    """Group edges into (dst block, src block) pairs, on the host in numpy.

    With ``reorder=True`` a reverse Cuthill-McKee order is computed and
    applied to both endpoints (a square adjacency only); ``plan.perm_nodes``
    maps new ids to old ones, so callers permute x with it and un-permute
    the output (or keep everything in the new id space). Weights stay in
    the caller's edge order either way.
    """
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    num_src = int(num_src if num_src is not None else num_nodes)
    perm_nodes = None
    if reorder:
        if num_src != int(num_nodes):
            raise ValueError("reorder needs a square adjacency")
        perm_nodes, inv = reorder_bandwidth(np.stack([src, dst]), num_nodes)
        src, dst = inv[src], inv[dst]
    plan, _ = _layout(src, dst, np.arange(src.shape[0]), num_nodes, num_src,
                      R, S, ET)
    plan.perm_nodes = perm_nodes
    return plan


def _weight_index(arrays, padded):
    """Where the kernel reads each edge's weight: w_perm (caller order), or
    with weights in the forward plan's order fwd_pos (None: the edge's own
    position)."""
    return arrays[6] if padded else arrays[2]


def _reference(x, w, plan, padded):
    """Plain PyTorch forward: ``index_add_`` of the weighted source rows in
    float32, cast once to x's dtype."""
    arrays = plan.arrays(x.device)
    return _reference_arrays(x, w, _weight_index(arrays, padded), arrays[0],
                             arrays[1], plan.num_nodes)


def _reference_arrays(x, w, w_index, row, col, num_nodes):
    """`_reference` on the plan's arrays: weights read at ``w_index``, or
    at each edge's own position when it is None."""
    acc = torch.promote_types(x.dtype, torch.float32)
    msg = x[col.long()].to(acc)
    if w is not None:
        wv = w.to(acc) if w_index is None else w.to(acc)[w_index.long()]
        msg = msg * wv[:, None]
    out = torch.zeros(num_nodes, x.shape[1], dtype=acc, device=x.device)
    return out.index_add_(0, row.long(), msg).to(x.dtype)


def _weights(edge_weight, plan, weights_padded):
    """float32 weights, checked against the plan, or None."""
    if edge_weight is None:
        return None
    n = plan.num_plan_edges if weights_padded else plan.num_edges
    if edge_weight.shape != (n,):
        raise ValueError(f"edge_weight shape {tuple(edge_weight.shape)} != "
                         f"({n},)")
    return edge_weight.float()


def spmm_block_pair_reference(x, edge_weight, plan, weights_padded=False):
    """Plain PyTorch version of `spmm_block_pair` (the tests' and the card
    checks' yardstick; the wrapper takes it for CPU tensors)."""
    _check_x(x, plan)
    return _reference(x, _weights(edge_weight, plan, weights_padded), plan,
                      weights_padded)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library()
    fwd = lib.gammagl_block_pair_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    dw = lib.gammagl_block_pair_dw
    dw.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    dw.restype = ctypes.c_int
    err = lib.gammagl_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, dw, err


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check_cuda(op, *tensors):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    for t in tensors:
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{op}: dtype {t.dtype} is not one of "
                            f"{_KERNEL_DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: inputs must be contiguous")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{op}: inputs on {t.device} as {t.dtype}, x "
                             f"on {x.device} as {x.dtype}")


def _forward(x, w, plan, padded):
    """The forward, the op ``gammagl::spmm_block_pair``: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (x f32 or bf16
    (N_src, F); w f32 read through `_weight_index`, or None) or
    raises."""
    arrays = plan.arrays(x.device)
    row, col, _, block_ptr, pair_src, row_ptr, _ = arrays
    w_index = None if w is None else _weight_index(arrays, padded)
    return torch.ops.gammagl.spmm_block_pair(
        x, w, w_index, row, col, block_ptr, pair_src, row_ptr,
        plan.num_nodes, plan.num_src, plan.R, plan.S)


@torch.library.custom_op("gammagl::spmm_block_pair", mutates_args=())
def _spmm_block_pair_op(x: torch.Tensor, w: Optional[torch.Tensor],
                        w_index: Optional[torch.Tensor], row: torch.Tensor,
                        col: torch.Tensor, block_ptr: torch.Tensor,
                        pair_src: torch.Tensor, row_ptr: torch.Tensor,
                        num_nodes: int, num_src: int, R: int,
                        S: int) -> torch.Tensor:
    """``out[d] = sum_e w[w_index[e]] * x[col[e]]`` over a block-pair
    plan's arrays (``w_index`` None: ``w[e]``)."""
    raise ValueError(f"gammagl::spmm_block_pair: no kernel for device "
                     f"{x.device}")


@_spmm_block_pair_op.register_kernel("cpu")
def _spmm_block_pair_cpu(x, w, w_index, row, col, block_ptr, pair_src,
                         row_ptr, num_nodes, num_src, R, S):
    return _reference_arrays(x, w, w_index, row, col, num_nodes)


@_spmm_block_pair_op.register_kernel("cuda")
def _spmm_block_pair_cuda(x, w, w_index, row, col, block_ptr, pair_src,
                          row_ptr, num_nodes, num_src, R, S):
    _check_cuda("spmm_block_pair", x)
    if w is not None:
        if w.device != x.device:
            raise ValueError(f"edge weights on {w.device}, x on {x.device}")
        w = w.contiguous()
    out = torch.empty(num_nodes, x.shape[1], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fwd, _, err = _kernels()
    with torch.cuda.device(x.device):
        code = fwd(x.data_ptr(), _ptr(w), _ptr(w_index), col.data_ptr(),
                   row_ptr.data_ptr(), block_ptr.data_ptr(),
                   pair_src.data_ptr(), out.data_ptr(), num_nodes, num_src,
                   x.shape[1], R, S, int(x.dtype == torch.bfloat16),
                   torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "spmm_block_pair", err)
    spmm_block_pair.launches += 1
    return out


@_spmm_block_pair_op.register_fake
def _spmm_block_pair_fake(x, w, w_index, row, col, block_ptr, pair_src,
                          row_ptr, num_nodes, num_src, R, S):
    return x.new_empty(num_nodes, x.shape[1])


def _dw_reference(x, g, row, col, w_perm, n_out):
    """`block_pair_dw`'s plain version on the plan's arrays: each edge's
    dot at its slot ``w_perm[e]`` of ``n_out`` (0 elsewhere), or in the
    plan's order when ``w_perm`` is None."""
    d = (g[row.long()].float() * x[col.long()].float()).sum(1)
    if w_perm is None:
        return d
    return torch.zeros(n_out, dtype=torch.float32,
                       device=x.device).index_put_((w_perm.long(),), d)


def _dw(x, g, plan, padded):
    """dw_e = <g[row_e], x[col_e]> at each edge's slot: (num_edges,) in the
    caller's order, 0 at edges the plan does not hold, or (num_plan_edges,)
    in the plan's order (``padded``); the op ``gammagl::block_pair_dw``."""
    n_out = plan.num_plan_edges if padded else plan.num_edges
    row, col, w_perm = plan.arrays(x.device)[:3]
    return torch.ops.gammagl.block_pair_dw(x, g, row, col,
                                           None if padded else w_perm, n_out)


@torch.library.custom_op("gammagl::block_pair_dw", mutates_args=())
def _block_pair_dw_op(x: torch.Tensor, g: torch.Tensor, row: torch.Tensor,
                      col: torch.Tensor, w_perm: Optional[torch.Tensor],
                      n_out: int) -> torch.Tensor:
    """``<g[row[e]], x[col[e]]>`` (float32) at slot ``w_perm[e]`` of
    ``n_out``, or at e when ``w_perm`` is None."""
    raise ValueError(f"gammagl::block_pair_dw: no kernel for device "
                     f"{x.device}")


@_block_pair_dw_op.register_kernel("cpu")
def _block_pair_dw_cpu(x, g, row, col, w_perm, n_out):
    return _dw_reference(x, g, row, col, w_perm, n_out)


@_block_pair_dw_op.register_kernel("cuda")
def _block_pair_dw_cuda(x, g, row, col, w_perm, n_out):
    _check_cuda("block_pair_dw", x, g)
    dw = torch.zeros(n_out, dtype=torch.float32, device=x.device)
    if col.shape[0] == 0:
        return dw
    _, fn, err = _kernels()
    with torch.cuda.device(x.device):
        code = fn(g.data_ptr(), x.data_ptr(), row.data_ptr(), col.data_ptr(),
                  _ptr(w_perm), dw.data_ptr(), col.shape[0], x.shape[1],
                  int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "block_pair_dw", err)
    block_pair_dw.launches += 1
    return dw


@_block_pair_dw_op.register_fake
def _block_pair_dw_fake(x, g, row, col, w_perm, n_out):
    return x.new_empty(n_out, dtype=torch.float32)


def _check_dw(x, g, plan):
    _check_x(x, plan)
    if g.dim() != 2 or g.shape[0] < plan.num_nodes or g.shape[1] != x.shape[1]:
        raise ValueError(f"g must be ({plan.num_nodes}, {x.shape[1]}), got "
                         f"{tuple(g.shape)}")


def block_pair_dw(x, g, plan, weights_padded=False):
    """The weight gradient of `spmm_block_pair` for the cotangent ``g``:
    ``dw_e = <g[dst_e], x[src_e]>`` (float32), in the caller's edge order
    (edges the plan does not hold get 0) or, with ``weights_padded``, in the
    plan's. A CUDA tensor launches the dw kernel (counted in
    ``block_pair_dw.launches``) or raises; a CPU tensor runs the plain
    version."""
    _check_dw(x, g, plan)
    return _dw(x, g.to(x.dtype).contiguous(), plan, weights_padded)


block_pair_dw.launches = 0


def block_pair_dw_reference(x, g, plan, weights_padded=False):
    """Plain PyTorch version of `block_pair_dw`."""
    _check_dw(x, g, plan)
    n_out = plan.num_plan_edges if weights_padded else plan.num_edges
    row, col, w_perm = plan.arrays(x.device)[:3]
    return _dw_reference(x, g.to(x.dtype), row, col,
                         None if weights_padded else w_perm, n_out)


class _SpmmBlockPair(torch.autograd.Function):
    """x, w -> out, with dx = the forward kernel on the transpose plan and
    dw the dw kernel, taken only when w needs a gradient (the JAX VJP
    `_bwd`, block_pair.py:264, computes both in XLA)."""

    @staticmethod
    def forward(ctx, x, w, plan, padded):
        ctx.save_for_backward(x, w)
        ctx.plan, ctx.padded = plan, padded
        return _forward(x, w, plan, padded)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("spmm_block_pair")
        x, w = ctx.saved_tensors
        plan, padded = ctx.plan, ctx.padded
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _pad_rows(_forward(g, w, plan.transpose(), padded),
                           x.shape[0])
        if w is not None and ctx.needs_input_grad[1]:
            dw = _dw(x, g, plan, padded)
        return dx, dw, None, None


def spmm_block_pair(x, edge_weight, plan, weights_padded=False):
    """out[d] = sum_{(s,d)} w_sd * x[s] over the plan's edges.

    x : (N_src, F) float32 or bfloat16, in the plan's node ids (apply
        ``plan.perm_nodes`` first when the plan was built with
        ``reorder=True``); the result (N_dst, F) has x's dtype, summed in
        float32 and rounded once.
    edge_weight : (num_edges,) in the caller's edge order, None for unit
        weights, or with ``weights_padded=True`` (num_plan_edges,) in the
        plan's edge order (``w[plan.w_perm]``).

    A CPU tensor takes `spmm_block_pair_reference`. A CUDA tensor launches
    the kernel or raises; it never falls back. Differentiable once in x and
    edge_weight (``create_graph=True`` raises on every device); the backward
    of x is another launch of the kernel, on the transpose plan (counted in
    ``spmm_block_pair.launches`` too), that of the weights `block_pair_dw`.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_block_pair: no kernel for device {x.device}")
    _check_x(x, plan)
    w = _weights(edge_weight, plan, weights_padded)
    return _SpmmBlockPair.apply(x, w, plan, bool(weights_padded))


spmm_block_pair.launches = 0


class HybridPlan:
    """Dense (dst block, src block) pairs on the block-pair kernel and the
    scattered tail on the CSR kernel.

    Real graphs are rarely banded throughout: a clustering order leaves a
    scattered cross-cluster tail whose near-empty pairs would pad a pure
    block-pair plan to a low fill. Pairs holding at least
    ``dense_threshold`` edges go to ``bp`` (a `BlockPairPlan`, or None), the
    rest to ``csr`` (a `CSRPlan`, or None); both sub-plans index the
    caller's edges (``bp.w_perm``, ``csr.perm``), so one weight vector
    serves both, and the two partial sums are added.
    """

    def __init__(self, bp, csr, num_nodes, num_edges, dense_frac):
        self.bp = bp
        self.csr = csr
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.dense_frac = float(dense_frac)

    def __repr__(self):
        return (f"HybridPlan(N={self.num_nodes}, E={self.num_edges}, "
                f"dense={self.dense_frac:.2f}, bp={self.bp!r}, "
                f"csr={self.csr!r})")


def pair_occupancy(src, dst, num_src, R=256, S=256):
    """The (dst block, src block) tiling's counts, on the host: (the edges
    of each edge's pair (E,), the edges of each pair (pairs,))."""
    pair = ((np.asarray(dst, np.int64).reshape(-1) // R)
            * (1 + int(num_src) // S)
            + np.asarray(src, np.int64).reshape(-1) // S)
    _, inverse, counts = np.unique(pair, return_inverse=True,
                                   return_counts=True)
    return counts[inverse.reshape(-1)], counts


def padded_fill(num_edges, counts, ET=256):
    """The block-pair plan's ``fill_ratio`` from its pairs' edge counts:
    edges over the slots of ceil(count / ET) tiles a pair."""
    return num_edges / max(int((-(-counts // ET) * ET).sum()), 1)


def build_hybrid_plan(src, dst, num_nodes, num_src=None, R=256, S=256,
                      ET=256, dense_threshold=None, csr_R=128, csr_ET=512,
                      occupancy=None):
    """Split edges by (dst block, src block) pair occupancy (host-side):
    pairs with at least ``dense_threshold`` edges (default 0.75 * ET) go to
    the block-pair plan, the rest to the CSR plan (``csr_R`` and
    ``csr_ET`` are the TPU tiling keywords, ignored there). The sub-plans'
    edge indices are remapped to the caller's edges. ``occupancy``: each
    edge's pair count, as `pair_occupancy` gives it (None: computed)."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    E = int(src.shape[0])
    num_src = int(num_src if num_src is not None else num_nodes)
    if dense_threshold is None:
        dense_threshold = (3 * ET) // 4
    if occupancy is None:
        occupancy, _ = pair_occupancy(src, dst, num_src, R, S)
    dense = occupancy >= dense_threshold
    d_idx = np.nonzero(dense)[0]
    t_idx = np.nonzero(~dense)[0]
    bp = None
    if len(d_idx):
        bp, _ = _layout(src[d_idx], dst[d_idx], d_idx, num_nodes, num_src,
                        R, S, ET)
        bp.num_edges = E
    csr = None
    if len(t_idx):
        csr = build_csr_plan(src[t_idx], dst[t_idx], num_nodes,
                             num_src=num_src, R=csr_R, ET=csr_ET)
        csr.perm = t_idx[csr.perm]
    return HybridPlan(bp, csr, num_nodes, E, len(d_idx) / max(E, 1))


def spmm_hybrid(x, edge_weight, plan):
    """out[d] = sum w_sd x[s] over both sub-plans of a `HybridPlan`.

    ``edge_weight`` is (E,) in the caller's edge order, or None. The dense
    part runs `spmm_block_pair`; the tail runs `spmm_csr` on its weights,
    taken at the tail plan's ``perm``; the partial sums are added in x's
    dtype, as the JAX package adds them."""
    out = None
    if plan.bp is not None:
        out = spmm_block_pair(x, edge_weight, plan.bp)
    if plan.csr is not None:
        w = None
        if edge_weight is not None:
            if edge_weight.shape != (plan.num_edges,):
                raise ValueError(f"edge_weight shape "
                                 f"{tuple(edge_weight.shape)} != "
                                 f"({plan.num_edges},)")
            w = edge_weight.float()[plan.csr.arrays(edge_weight.device)[2]]
        part = spmm_csr(x, w, plan.csr, weights_padded=True)
        out = part if out is None else out + part
    return out
