"""The ``torch.library`` ops of rows 5-15 and the models that export
through them.

* ``torch.library.opcheck`` of every op (`gammagl::spmm_csr_acc` and its
  ``_out`` form, ``sddmm_csr``, ``expand_dst_csr``, ``flash_forward``,
  ``flash_backward``, ``segment_extreme``, ``segment_max_bwd``,
  ``hgt_forward``, ``hgt_backward``, ``spmm_block_pair``,
  ``block_pair_dw``): float32, and bfloat16 where the plain version takes
  it; E = 0, empty rows, a hub row past `ROW_SPLIT` (rows 5, 10-12) or
  `EDGE_SPLIT` (rows 6-9), H = 1 and H > 1, ``keep`` None and given.
* Each export path (`serve.export_forward`): FusedGATModel and the planned
  GATModel (row 10), GATV2Model (rows 9, 10 per edge), GraphSAGEModel with
  ``aggr="max"`` (row 12), HANModel (row 10 a relation), HGTModel on its
  fused route (row 13), SimpleHGNModel (rows 1, 4, 9, 12 per edge), GCN on
  a `BlockPairPlan` and on a `HybridPlan` from `Graph.auto_plan` (row 15,
  and row 1 for the hybrid's tail), and small modules around
  `spmm_csr_acc` (row 5) and `sddmm_csr` / `sddmm_csr_mh` (rows 8 and 6).
  The graph names its ops and no plain version's (no ``scatter_reduce``,
  no ``repeat_interleave``, ``index_add`` only of the degree counts); the
  program is saved, loaded in one fresh process that imports no model
  code, and its output is bitwise the eager port's.
* Each path against the JAX package on the same parameters: JAX's own
  ``serve.export_forward(...).call``; rows 5, 6 and 8 against JAX's
  kernels (`segment_matmul_dyn_packed(out_acc=)`, `sddmm_csr`,
  `sddmm_csr_mh`) in interpret mode. JAX's ``export_forward`` reads a
  shape from each input (``_specs``), so a dict input raises there
  (ROADMAP C60): HAN and HGT are exported through it with the dicts'
  leaves as flat inputs, rebuilt inside ``apply_fn``. The port's planned
  GAT is held against JAX's planned GAT (Pallas, interpret mode); the
  other models against JAX's COO route, the function the port's plan
  routes are held to in their parity tests.
* The C54 tests, on the other plan kinds: tracing fills no cache of a
  `BlockPairPlan`, a `HybridPlan`, a plan's `EDGE_SPLIT` items or the
  plans of a ``plan_dict``; after an export each plan's eager calls are
  bitwise what they were and a second export works.

Tolerances, relative to max |out|: float32 1e-5 against JAX's XLA route,
1e-4 against its Pallas route (bf16x3 products that drop the lo*lo term);
HGT's bfloat16 fused route 3e-2 (its parity test's bound: the two
packages round p and the sums at other places); row 5 at bfloat16 F = 256
(the JAX packed kernel's only width) 2e-2 against float64, as its parity
test states.
"""

import functools
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
import gammagl_tpu.models as jm  # noqa: E402
import gammagl_tpu.models.compat as jc  # noqa: E402
from examples.common import (  # noqa: E402
    synthetic_hetero as jax_synthetic_hetero)
from gammagl_tpu import serve as jserve  # noqa: E402
from gammagl_tpu.data import Graph as JaxGraph  # noqa: E402
from gammagl_tpu.layers.conv import FusedGATConv as JaxFusedGATConv  # noqa
from gammagl_tpu.ops.pallas import (  # noqa: E402
    build_csr_plan as jax_build_csr_plan)
from gammagl_tpu.ops.pallas import segment_matmul as jsm  # noqa: E402
from gammagl_tpu.ops.pallas import sddmm_csr as jax_sddmm_csr  # noqa: E402
from gammagl_tpu.ops.pallas import (  # noqa: E402
    sddmm_csr_mh as jax_sddmm_csr_mh)
from gammagl_tpu.parallel import halo_plan as jhp  # noqa: E402

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.data import Graph  # noqa: E402
from gammagl_tpu_torch.examples import common, simplehgn_trainer  # noqa
from gammagl_tpu_torch.ops import cuda as k  # noqa: E402
from gammagl_tpu_torch.ops.cuda.flash_attention import _plan_args  # noqa
from gammagl_tpu_torch.ops.cuda.sddmm_csr import _edge_items  # noqa: E402
from gammagl_tpu_torch.ops.cuda.segment_matmul import (  # noqa: E402
    EDGE_SPLIT, _op_args)
from gammagl_tpu_torch.serve import (export_forward,  # noqa: E402
                                     load_exported, save_exported)
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

N, FEAT = 40, 12
ROW_HUB = k.ROW_SPLIT + 37
EDGE_HUB = EDGE_SPLIT + 45
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _edges(seed, n=N, e=200, hub=0, n_src=None, empty=0):
    """Random edges into rows [0, n - empty) (the last ``empty`` rows get
    none), ``hub`` more into row 0, shuffled."""
    rng = np.random.default_rng(seed)
    n_src = n if n_src is None else n_src
    src = rng.integers(0, n_src, e + hub)
    dst = np.concatenate([rng.integers(0, n - empty, e),
                          np.zeros(hub, np.int64)])
    order = rng.permutation(e + hub)
    return np.stack([src[order], dst[order]]).astype(np.int64)


# -- opcheck of every op -------------------------------------------------

def _csr_plan(case):
    """The plan of an opcheck case: ``"hub"`` a row past ``ROW_SPLIT``
    (and so past ``EDGE_SPLIT``), ``"edge_hub"`` past ``EDGE_SPLIT``
    only, ``"empty"`` E = 0, else random edges with 9 empty rows."""
    if case == "empty":
        return k.build_csr_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                N)
    hub = {"hub": ROW_HUB, "edge_hub": EDGE_HUB}.get(case, 0)
    ei = _edges(3, hub=hub, empty=9)
    return k.build_csr_plan(ei[0], ei[1], N)


def _rand(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(dtype)


def _acc_args(case, dtype, out):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(1)
    x = _rand(g, N, 8, dtype=dtype)
    w = None if case == "empty" else torch.rand(plan.num_edges, generator=g)
    prev = _rand(g, N, 8, dtype=dtype)
    if out:
        return "spmm_csr_acc_out", (x, w, prev, torch.empty_like(prev),
                                    *_op_args(plan, "cpu"))
    return "spmm_csr_acc", (x, w, None if case == "hub" else prev,
                            *_op_args(plan, "cpu"))


def _sddmm_args(case, dtype, gather, H):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(2)
    rows = N if gather else plan.num_edges
    return "sddmm_csr", (_rand(g, rows, 4 * H, dtype=dtype),
                         _rand(g, N, 4 * H, dtype=dtype),
                         *_edge_items(plan, "cpu"), H, gather)


def _expand_args(case, dtype, H):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(3)
    scale = None if H is None else torch.rand(plan.num_edges, H, generator=g)
    return "expand_dst_csr", (_rand(g, N, 6, dtype=dtype), scale,
                              *_edge_items(plan, "cpu"))


def _flash_inputs(case, dtype, gather, H, keep):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(4)
    rows = N if gather else plan.num_edges
    score = _rand(g, rows, H)
    a_dst = _rand(g, N, H)
    msg = _rand(g, rows, 3 * H, dtype=dtype)
    kp = ((torch.rand(plan.num_edges, H, generator=g) < 0.7).float() / 0.7
          if keep else None)
    return plan, (score, a_dst, msg, kp)


def _flash_fwd_args(case, dtype, gather, H, keep):
    plan, (score, a_dst, msg, kp) = _flash_inputs(case, dtype, gather, H,
                                                  keep)
    return "flash_forward", (score, a_dst, msg, kp,
                             *_plan_args(plan, "cpu"), 0.2, gather)


def _flash_bwd_args(case, dtype, gather, H, keep):
    plan, (score, a_dst, msg, kp) = _flash_inputs(case, dtype, gather, H,
                                                  keep)
    out, m, l = k.flash_forward(score, a_dst, msg, kp, plan, 0.2, gather)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    rowptr, col, perm = plan.arrays("cpu")
    return "flash_backward", (score, a_dst, msg, kp, m, l, out,
                              grad.to(msg.dtype), rowptr, col, perm, 0.2,
                              gather)


def _max_inputs(case, dtype, per_edge, weights):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(6)
    rows = plan.num_edges if per_edge else N
    # integer-valued rows: ties, whose cotangent the winners share
    x = torch.randint(-3, 4, (rows, 5), generator=g).to(dtype)
    w = (torch.randint(1, 3, (plan.num_edges,), generator=g).float()
         if weights else None)
    return plan, x, w


def _extreme_args(case, dtype, per_edge, negate, weights):
    plan, x, w = _max_inputs(case, dtype, per_edge, weights)
    return "segment_extreme", (x, w, *_op_args(plan, "cpu"), per_edge,
                               negate)


def _max_bwd_args(case, dtype, per_edge, weights):
    plan, x, w = _max_inputs(case, dtype, per_edge, weights)
    out = k.spmm_max_csr_reference(x, w, plan, weights_padded=True) if (
        not per_edge) else k.segment_max_csr_reference(x, plan)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    return "segment_max_bwd", (x, w, out, grad.to(dtype),
                               *_op_args(plan, "cpu"), per_edge, weights)


def _hgt_inputs(case, dtype, H):
    plan = _csr_plan(case)
    g = torch.Generator().manual_seed(8)
    return plan, _rand(g, N, 2 * H * 4, dtype=dtype), _rand(g, N, H, 4,
                                                           dtype=dtype)


def _hgt_fwd_args(case, dtype, H):
    plan, kv, q = _hgt_inputs(case, dtype, H)
    return "hgt_forward", (kv, q, *plan.arrays("cpu")[:2])


def _hgt_bwd_args(case, dtype, H):
    plan, kv, q = _hgt_inputs(case, dtype, H)
    out, m, l = k.hgt_forward(kv, q, plan)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    return "hgt_backward", (kv, q, out, grad.to(dtype), m, l,
                            *plan.arrays("cpu")[:2])


def _bp_plan(case, transpose=False):
    if case == "empty":
        plan = k.build_block_pair_plan(np.zeros(0, np.int64),
                                       np.zeros(0, np.int64), N, R=8, S=8)
    else:
        ei = _edges(10, e=300, n_src=56, empty=9)
        plan = k.build_block_pair_plan(ei[0], ei[1], N, num_src=56, R=8,
                                       S=16)
    return plan.transpose() if transpose else plan


def _bp_args(case, dtype, weights):
    """weights: None, "caller" (read at w_perm), "padded" (own order) or
    "transpose" (the backward's plan, read at fwd_pos)."""
    plan = _bp_plan(case, weights == "transpose")
    g = torch.Generator().manual_seed(11)
    x = _rand(g, plan.num_src, 6, dtype=dtype)
    arrays = plan.arrays("cpu")
    row, col, w_perm, block_ptr, pair_src, row_ptr, fwd_pos = arrays
    w = w_index = None
    if weights is not None:
        n = plan.num_plan_edges if weights == "padded" else plan.num_edges
        w = torch.rand(n, generator=g)
        w_index = {"caller": w_perm, "padded": None,
                   "transpose": fwd_pos}[weights]
    return "spmm_block_pair", (x, w, w_index, row, col, block_ptr, pair_src,
                               row_ptr, plan.num_nodes, plan.num_src,
                               plan.R, plan.S)


def _bp_dw_args(case, dtype, padded):
    plan = _bp_plan(case)
    g = torch.Generator().manual_seed(12)
    x = _rand(g, plan.num_src, 6, dtype=dtype)
    gy = _rand(g, N, 6, dtype=dtype)
    row, col, w_perm = plan.arrays("cpu")[:3]
    n_out = plan.num_plan_edges if padded else plan.num_edges
    return "block_pair_dw", (x, gy, row, col, None if padded else w_perm,
                             n_out)


BF = torch.bfloat16
F32 = torch.float32
OPCHECK = {
    "acc_hub": lambda: _acc_args("hub", F32, False),
    "acc_prev": lambda: _acc_args("edge_hub", F32, False),
    "acc_empty": lambda: _acc_args("empty", F32, False),
    "acc_bf16": lambda: _acc_args("rand", BF, False),
    "acc_out_hub": lambda: _acc_args("hub", F32, True),
    "acc_out_bf16": lambda: _acc_args("rand", BF, True),
    "sddmm_gather_h1": lambda: _sddmm_args("edge_hub", F32, True, 1),
    "sddmm_edge_h2": lambda: _sddmm_args("edge_hub", F32, False, 2),
    "sddmm_empty": lambda: _sddmm_args("empty", F32, True, 2),
    "sddmm_bf16": lambda: _sddmm_args("rand", BF, False, 2),
    "expand": lambda: _expand_args("edge_hub", F32, None),
    "expand_scaled_h2": lambda: _expand_args("edge_hub", F32, 2),
    "expand_empty": lambda: _expand_args("empty", F32, 1),
    "expand_bf16": lambda: _expand_args("rand", BF, 3),
    "flash_fwd_gather_keep": lambda: _flash_fwd_args("hub", F32, True, 2,
                                                     True),
    "flash_fwd_edge_h1": lambda: _flash_fwd_args("hub", F32, False, 1,
                                                 False),
    "flash_fwd_empty": lambda: _flash_fwd_args("empty", F32, True, 2, False),
    "flash_fwd_bf16": lambda: _flash_fwd_args("rand", BF, True, 2, True),
    "flash_bwd_gather_keep": lambda: _flash_bwd_args("hub", F32, True, 2,
                                                     True),
    "flash_bwd_edge_h1": lambda: _flash_bwd_args("rand", F32, False, 1,
                                                 False),
    "flash_bwd_empty": lambda: _flash_bwd_args("empty", F32, False, 2,
                                               True),
    "flash_bwd_bf16": lambda: _flash_bwd_args("rand", BF, True, 2, False),
    "max_gather_w": lambda: _extreme_args("hub", F32, False, False, True),
    "min_gather": lambda: _extreme_args("rand", F32, False, True, False),
    "max_edge": lambda: _extreme_args("hub", F32, True, False, False),
    "min_edge_empty": lambda: _extreme_args("empty", F32, True, True, False),
    "max_bf16": lambda: _extreme_args("rand", BF, False, False, True),
    "max_bwd_gather_dw": lambda: _max_bwd_args("hub", F32, False, True),
    "max_bwd_edge": lambda: _max_bwd_args("hub", F32, True, False),
    "max_bwd_empty": lambda: _max_bwd_args("empty", F32, False, False),
    "max_bwd_bf16": lambda: _max_bwd_args("rand", BF, False, True),
    "hgt_fwd_h1": lambda: _hgt_fwd_args("hub", F32, 1),
    "hgt_fwd_h2": lambda: _hgt_fwd_args("rand", F32, 2),
    "hgt_fwd_empty": lambda: _hgt_fwd_args("empty", F32, 2),
    "hgt_fwd_bf16": lambda: _hgt_fwd_args("rand", BF, 2),
    "hgt_bwd_h2": lambda: _hgt_bwd_args("hub", F32, 2),
    "hgt_bwd_empty": lambda: _hgt_bwd_args("empty", F32, 1),
    "hgt_bwd_bf16": lambda: _hgt_bwd_args("rand", BF, 2),
    "bp_unweighted": lambda: _bp_args("rand", F32, None),
    "bp_caller": lambda: _bp_args("rand", F32, "caller"),
    "bp_padded": lambda: _bp_args("rand", F32, "padded"),
    "bp_transpose": lambda: _bp_args("rand", F32, "transpose"),
    "bp_empty": lambda: _bp_args("empty", F32, "caller"),
    "bp_bf16": lambda: _bp_args("rand", BF, "caller"),
    "bp_dw": lambda: _bp_dw_args("rand", F32, False),
    "bp_dw_padded": lambda: _bp_dw_args("rand", F32, True),
    "bp_dw_empty": lambda: _bp_dw_args("empty", F32, False),
    "bp_dw_bf16": lambda: _bp_dw_args("rand", BF, False),
}


@pytest.mark.parametrize("case", sorted(OPCHECK))
def test_op_passes_opcheck(case):
    name, args = OPCHECK[case]()
    torch.library.opcheck(getattr(torch.ops.gammagl, name).default, args)


# -- the export paths ------------------------------------------------------

def _graph(seed=0, n=N, e=200):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 6, e)])
    ei = np.concatenate([ei, np.stack([np.arange(n)] * 2)], 1)
    return rng.normal(size=(n, FEAT)).astype(np.float32), ei.astype(np.int64)


def _banded(n=4096, band=64, e=32000, seed=0):
    """tests/ops/test_auto_plan.py's banded graph: a block-pair plan."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-band, band + 1, e), 0, n - 1)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.stack([src, dst]).astype(np.int64))


def _mixed(n=4096, per=6000, tail=4000, seed=9):
    """Dense 256x256 diagonal windows and a scattered tail: a hybrid
    plan."""
    rng = np.random.default_rng(seed)
    sd, dd = [], []
    for b in range(n // 256):
        sd.append(b * 256 + rng.integers(0, 256, per))
        dd.append(b * 256 + rng.integers(0, 256, per))
    sd.append(rng.integers(0, n, tail))
    dd.append(rng.integers(0, n, tail))
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.stack([np.concatenate(sd), np.concatenate(dd)]).astype(
                np.int64))


def _jax_call(apply_fn, params, inputs, **kw):
    """JAX's own artifact of ``apply_fn`` on ``inputs``: exported,
    serialized, deserialized and called."""
    blob = jserve.export_forward(apply_fn, params, inputs, **kw)
    back = jax.export.deserialize(blob.serialize())
    return np.asarray(back.call(*inputs), np.float32)


def _flat_hetero(jmodel, keys):
    """``apply_fn`` over the leaves of (x_dict, edge_index_dict), in the
    order of ``keys``: JAX's export_forward takes flat arrays only."""
    (xk, ek) = keys

    def apply(p, *leaves):
        return jmodel.apply(p, dict(zip(xk, leaves[:len(xk)])),
                            dict(zip(ek, leaves[len(xk):])))
    return apply


def _gat():
    x, ei = _graph(1)
    jmodel = jm.GATModel(hidden_dim=4, num_class=5, heads=2)
    params = _np_tree(jax.jit(jmodel.init)(KEY, x, ei))
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan()
    want = _jax_call(lambda p, a, b: jmodel.apply(p, a, b, plan=jplan),
                     params, (jnp.asarray(x), jnp.asarray(ei)))
    model = load_jax_params(tm.GATModel(4, 5, heads=2), params)
    return (model, (x, ei), {"plan": Graph(x=x, edge_index=ei).csr_plan()},
            want, 1e-4)


def _fused_gat():
    x, ei = _graph(2)
    jplan = JaxFusedGATConv.to_graph_format(ei, N, R=8, ET=16)
    jmodel = jc.FusedGATModel(hidden_dim=4, num_class=5, heads=2)
    params = _np_tree(jmodel.init(KEY, jnp.asarray(x), jnp.asarray(ei),
                                  jplan))
    want = _jax_call(lambda p, a, b: jmodel.apply(p, a, b, jplan), params,
                     (jnp.asarray(x), jnp.asarray(ei)))
    model = load_jax_params(tm.FusedGATModel(hidden_dim=4, num_class=5,
                                             heads=2), params)
    return (model, (x, ei), {"plan": tm.FusedGATModel.to_graph_format(ei, N)},
            want, 1e-5)


def _gatv2():
    x, ei = _graph(3)
    jmodel = jm.GATV2Model(hidden_dim=4, num_class=5, heads=2)
    params = _np_tree(jax.jit(jmodel.init)(KEY, x, ei))
    want = _jax_call(jmodel.apply, params, (jnp.asarray(x), jnp.asarray(ei)))
    model = load_jax_params(tm.GATV2Model(4, 5, heads=2), params)
    return (model, (x, ei), {"plan": Graph(x=x, edge_index=ei).csr_plan()},
            want, 1e-5)


def _sage_max():
    x, ei = _graph(4)
    jmodel = jm.GraphSAGEModel(hidden_dim=8, num_class=4, num_layers=2,
                               aggr="max")
    params = _np_tree(jax.jit(jmodel.init)(KEY, x, ei))
    want = _jax_call(jmodel.apply, params, (jnp.asarray(x), jnp.asarray(ei)))
    model = load_jax_params(tm.GraphSAGEModel(8, 4, num_layers=2,
                                              aggr="max"), params)
    return (model, (x, ei), {"plan": k.build_csr_plan(ei[0], ei[1], N)},
            want, 1e-5)


def _hetero_inputs(seed):
    jhg, target = jax_synthetic_hetero(seed)
    hg, _ = common.synthetic_hetero(seed)
    x_dict = {nt: np.asarray(x, np.float32) for nt, x in hg.x_dict.items()}
    ei_dict = {et: np.asarray(ei, np.int64)
               for et, ei in hg.edge_index_dict.items()}
    return jhg, hg, target, x_dict, ei_dict


def _hetero_want(jmodel, params, x_dict, ei_dict):
    keys = (list(x_dict), list(ei_dict))
    leaves = [jnp.asarray(v) for v in x_dict.values()] + [
        jnp.asarray(v) for v in ei_dict.values()]
    return _jax_call(_flat_hetero(jmodel, keys), params, tuple(leaves))


def _han():
    jhg, hg, target, x_dict, ei_dict = _hetero_inputs(1)
    jmodel = jm.HANModel(jhg.metadata(), 4, 3, target, heads=2)
    params = _np_tree(jax.jit(jmodel.init)(
        KEY, {k_: jnp.asarray(v) for k_, v in x_dict.items()},
        {k_: jnp.asarray(v) for k_, v in ei_dict.items()}))
    want = _hetero_want(jmodel, params, x_dict, ei_dict)
    model = load_jax_params(tm.HANModel(hg.metadata(), 4, 3, target,
                                        heads=2, in_channels=32), params)
    return (model, (x_dict, ei_dict), {"plan_dict": hg.csr_plans()}, want,
            1e-5)


def _hgt():
    """bf16 on window plans: every relation takes the fused kernel."""
    jhg, hg, target, x_dict, ei_dict = _hetero_inputs(0)
    jmodel = jm.HGTModel(metadata=jhg.metadata(), hidden_channels=128,
                         num_class=3, target_ntype=target, heads=2,
                         dtype=jnp.bfloat16)
    params = _np_tree(jax.jit(jmodel.init)(
        {"params": KEY, "dropout": KEY},
        {k_: jnp.asarray(v) for k_, v in x_dict.items()},
        {k_: jnp.asarray(v) for k_, v in ei_dict.items()}))
    want = _hetero_want(jmodel, params, x_dict, ei_dict)
    model = load_jax_params(tm.HGTModel(hg.metadata(), 128, 3, target,
                                        heads=2, dtype=torch.bfloat16),
                            params)
    return (model, (x_dict, ei_dict),
            {"plan_dict": hg.csr_plans(window=True)}, want, 3e-2)


def _simplehgn():
    data = simplehgn_trainer.typed_graph(common.synthetic_hetero(2)[0])
    x, ei, et = data["x"], data["edge_index"], data["edge_type"]
    n = x.shape[0]
    jmodel = jm.SimpleHGNModel(3, 4, 3, heads=2)
    params = _np_tree(jax.jit(jmodel.init)(
        {"params": KEY, "dropout": KEY}, x, ei, et))
    want = _jax_call(jmodel.apply, params,
                     (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(et)))
    model = load_jax_params(tm.SimpleHGNModel(3, 4, 3, heads=2,
                                              in_channels=32), params)
    return (model, (x, ei, et), {"plan": k.build_csr_plan(ei[0], ei[1], n)},
            want, 1e-5)


def _gcn_on(make, kind):
    x, ei = make()
    plan = Graph(x=x, edge_index=ei).auto_plan()
    assert isinstance(plan, kind), plan
    jmodel = jm.GCNModel(hidden_dim=16, num_class=5)
    params = _np_tree(jax.jit(jmodel.init)(KEY, x, ei))
    want = _jax_call(jmodel.apply, params, (jnp.asarray(x), jnp.asarray(ei)))
    model = load_jax_params(tm.GCNModel(hidden_dim=16, num_class=5), params)
    return model, (x, ei), {"plan": plan}, want, 1e-5


class _Acc(torch.nn.Module):
    def forward(self, x, w, prev, plan):
        return k.spmm_csr_acc(x, w, plan, prev=prev)


def _acc():
    """Row 5 at the JAX packed kernel's width (bf16, F = 256), a hub row
    past ROW_SPLIT among rows whose last 9 get no edge."""
    rng = np.random.default_rng(20)
    n_dst, n_src, R, ET, F = 40, 56, 8, 64, 256
    ei = _edges(21, n=n_dst, e=300, hub=ROW_HUB, n_src=n_src, empty=9)
    src, dst = ei
    w = rng.normal(size=src.shape[0]).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.normal(size=(n_src, F)), jnp.bfloat16),
                   np.float32)
    prev = np.asarray(jnp.asarray(rng.normal(size=(n_dst, F)), jnp.bfloat16),
                      np.float32)
    jplan = jsm.build_csr_plan(src, dst, n_dst, num_src=n_src, R=R, ET=ET)
    nblocks = -(-n_dst // R)
    g = jnp.take(jsm.pack_halves(jnp.asarray(x, jnp.bfloat16)),
                 jnp.asarray(jplan.src_pad), axis=0)
    prev_pad = jnp.zeros((nblocks * R, F), jnp.bfloat16).at[:n_dst].set(
        jnp.asarray(prev, jnp.bfloat16))
    want = np.asarray(jax.jit(functools.partial(
        jsm.segment_matmul_dyn_packed, R=R, ET=ET, nblocks=nblocks,
        interpret=True))(g, jnp.asarray(jhp._permute_w(w, jplan)),
                         jnp.asarray(jplan.local_row),
                         jnp.asarray(jplan.tile_block),
                         jnp.asarray(jplan.tile_first),
                         out_acc=prev_pad)[:n_dst].astype(jnp.float32))
    dense = np.zeros((n_dst, n_src))
    np.add.at(dense, (dst, src), w.astype(np.float64))
    ref = prev.astype(np.float64) + dense @ x.astype(np.float64)
    np.testing.assert_allclose(want, ref, rtol=2e-2,
                               atol=2e-2 * np.abs(ref).max())
    plan = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    inputs = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
              torch.from_numpy(prev).to(torch.bfloat16))
    return _Acc(), inputs, {"plan": plan}, want, 2e-2


class _Sddmm(torch.nn.Module):
    def forward(self, xs, xd, msg, plan):
        return torch.cat([k.sddmm_csr(xs, xd, plan)[:, None],
                          k.sddmm_csr_mh(None, xd.view(-1, 2, 3), plan,
                                         msg=msg.view(-1, 2, 3))], 1)


def _sddmm():
    """Rows 8 (gathered, one head) and 6 (per-edge rows, two heads) on a
    hub row past EDGE_SPLIT; the port's CSR order mapped to the JAX
    plan's lanes."""
    n_dst, n_src = N, 55
    ei = _edges(22, n=n_dst, e=200, hub=EDGE_HUB, n_src=n_src, empty=9)
    src, dst = ei
    rng = np.random.default_rng(23)
    xs = rng.normal(size=(n_src, 6)).astype(np.float32)
    xd = rng.normal(size=(n_dst, 6)).astype(np.float32)
    msg_c = rng.normal(size=(src.shape[0], 6)).astype(np.float32)
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src, R=8, ET=32)
    valid = jplan.valid
    msg_lanes = np.zeros((len(valid), 6), np.float32)
    msg_lanes[valid] = msg_c[jplan.perm[valid]]

    @jax.jit
    def ref(xs, xd, ml):
        return (jax_sddmm_csr(xs, xd, jplan),
                jax_sddmm_csr_mh(None, xd.reshape(-1, 2, 3), jplan,
                                 msg=ml.reshape(-1, 2, 3)))

    one, two = ref(jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(msg_lanes))
    lanes = np.concatenate([np.asarray(one)[:, None], np.asarray(two)], 1)
    want = np.zeros((src.shape[0], 3), np.float32)  # the caller's order
    want[jplan.perm[valid]] = lanes[valid]
    plan = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    assert plan.row_split(EDGE_SPLIT).cut_row.shape[0] > 0
    inputs = (torch.from_numpy(xs), torch.from_numpy(xd),
              torch.from_numpy(msg_c[plan.perm]))
    return _Sddmm(), inputs, {"plan": plan}, want[plan.perm], 1e-4


PATHS = {
    "gat": (_gat, {"flash_forward"}),
    "fused_gat": (_fused_gat, {"flash_forward"}),
    "gatv2": (_gatv2, {"expand_dst_csr", "flash_forward"}),
    "sage_max": (_sage_max, {"segment_extreme"}),
    "han": (_han, {"flash_forward"}),
    "hgt": (_hgt, {"hgt_forward"}),
    "simplehgn": (_simplehgn, {"spmm_csr", "expand_dst_csr",
                               "segment_extreme"}),
    "gcn_block_pair": (lambda: _gcn_on(_banded, k.BlockPairPlan),
                       {"spmm_block_pair"}),
    "gcn_hybrid": (lambda: _gcn_on(_mixed, k.HybridPlan),
                   {"spmm_block_pair", "spmm_csr"}),
    "acc": (_acc, {"spmm_csr_acc"}),
    "sddmm": (_sddmm, {"sddmm_csr"}),
}

# the ops the plain versions of the kernels are written with: an exported
# graph that holds one of them (index_add_ beyond a degree count) has
# recorded a plain version in place of an op
PLAIN = ("scatter_reduce", "repeat_interleave", "index_put")

# the fresh process: it loads every artifact of a directory, runs each on
# its saved inputs, and saves the outputs (argv: the directory, the names)
LOADER = r'''
import sys, torch
from gammagl_tpu_torch.serve import load_exported
d = sys.argv[1]
for name in sys.argv[2:]:
    prog = load_exported(f"{d}/{name}.pt2")
    torch.save(prog(*torch.load(f"{d}/{name}.in.pt")), f"{d}/{name}.out.pt")
bad = [m for m in sys.modules if m.startswith((
    "gammagl_tpu_torch.models", "gammagl_tpu_torch.layers", "jax",
    "gammagl_tpu."))]
assert not bad, bad
'''


def _tensors(a):
    if isinstance(a, dict):
        return {key: _tensors(v) for key, v in a.items()}
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.asarray(a))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Every path: exported, saved, loaded in one fresh process; by name,
    (program, eager output, loaded output, JAX reference, tolerance)."""
    d = tmp_path_factory.mktemp("export_ops")
    out = {}
    for name, (make, _) in PATHS.items():
        model, inputs, kwargs, want, tol = make()
        tin = tuple(_tensors(a) for a in inputs)
        with torch.no_grad():
            eager = model.eval()(*tin, **kwargs)
        ep = export_forward(model, inputs, device="cpu", **kwargs)
        save_exported(ep, d / f"{name}.pt2")
        torch.save(tin, d / f"{name}.in.pt")
        out[name] = [ep, eager, None, want, tol]
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", LOADER, str(d), *PATHS],
                   check=True, cwd=ROOT, env=env, timeout=300)
    for name in PATHS:
        out[name][2] = torch.load(d / f"{name}.out.pt")
    return out


@pytest.mark.parametrize("name", sorted(PATHS))
def test_export_records_the_ops_and_no_plain_version(exported, name):
    ep = exported[name][0]
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    ops = {t.split(".")[1] for t in targets if t.startswith("gammagl.")}
    assert ops == PATHS[name][1]
    assert all(t.endswith(".default") for t in targets
               if t.startswith("gammagl."))
    assert not any(p in t for t in targets for p in PLAIN), targets
    for node in ep.graph.nodes:  # GCN's degree counts add ones, (N + 1,)
        if node.op == "call_function" and "index_add" in str(node.target):
            assert node.args[3].meta["val"].dim() == 1
    assert len(dict(ep.named_buffers())) > 0  # the plans' arrays


@pytest.mark.parametrize("name", sorted(PATHS))
def test_loaded_program_is_the_eager_port_bitwise(exported, name):
    _, eager, loaded, _, _ = exported[name]
    assert loaded.dtype == eager.dtype and not loaded.requires_grad
    assert torch.equal(loaded, eager)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_export_matches_jax(exported, name):
    _, _, loaded, want, tol = exported[name]
    got = loaded.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# -- C54 on the other plan kinds -----------------------------------------

def _hetero_plans():
    _, hg, _, x_dict, ei_dict = _hetero_inputs(1)
    return hg.csr_plans(), x_dict, ei_dict


def _caches(plan):
    """Every device cache a plan (or the plans it holds) keeps."""
    if isinstance(plan, dict):
        return [c for p in plan.values() for c in _caches(p)]
    if isinstance(plan, k.HybridPlan):
        return _caches(plan.bp) + _caches(plan.csr)
    if isinstance(plan, k.BlockPairPlan):
        return [plan._placed, plan._transpose]
    return [plan._placed, plan._split_placed, plan._transpose,
            plan._edge_scatter]


def _reads(plan):
    """A module that reads every array and transpose of ``plan`` in its
    forward (the EDGE_SPLIT items of a CSR plan too)."""

    def one(p, v):
        if isinstance(p, k.BlockPairPlan):
            arrays = p.arrays(v.device) + p.transpose().arrays(v.device)
            return sum(a.sum() for a in arrays if a is not None)
        return (p.arrays(v.device)[1].sum()
                + p.split_arrays(v.device)[0].sum()
                + p.split_arrays(v.device, EDGE_SPLIT)[0].sum()
                + p.transpose().arrays(v.device)[1].sum()
                + p.edge_scatter_plan().arrays(v.device)[1].sum())

    class Reads(torch.nn.Module):
        def forward(self, v):
            total = v.sum()
            for p in _caches_of(plan):
                total = total + one(p, v)
            return total
    return Reads()


def _caches_of(plan):
    if isinstance(plan, dict):
        return list(plan.values())
    if isinstance(plan, k.HybridPlan):
        return [p for p in (plan.bp, plan.csr) if p is not None]
    return [plan]


def _plan_of(kind):
    if kind == "edge_split":
        ei = _edges(30, hub=EDGE_HUB)
        return k.build_csr_plan(ei[0], ei[1], N)
    if kind == "block_pair":
        return Graph(x=_banded()[0], edge_index=_banded()[1]).auto_plan()
    if kind == "hybrid":
        return Graph(x=_mixed()[0], edge_index=_mixed()[1]).auto_plan()
    return _hetero_plans()[0]


@pytest.mark.parametrize("kind", ["edge_split", "block_pair", "hybrid",
                                  "plan_dict"])
def test_tracing_fills_no_cache_of_a_plan(kind):
    plan = _plan_of(kind)
    torch.export.export(_reads(plan), (torch.ones(3),))
    for cache in _caches(plan):
        assert not cache


def _unpoisoned_case(kind):
    """(model, inputs, the plan keyword) of one plan kind."""
    torch.manual_seed(0)
    if kind == "edge_split":
        x, _ = _graph(5)
        ei = _edges(31, hub=EDGE_HUB)
        return (tm.GATV2Model(4, 5, heads=2), (x, ei),
                lambda: {"plan": k.build_csr_plan(ei[0], ei[1], N)})
    if kind in ("block_pair", "hybrid"):
        x, ei = _banded() if kind == "block_pair" else _mixed()
        return (tm.GCNModel(hidden_dim=16, num_class=5),
                (x, ei),
                lambda: {"plan": Graph(x=x, edge_index=ei).auto_plan()})
    _, hg, target, x_dict, ei_dict = _hetero_inputs(1)
    return (tm.HANModel(hg.metadata(), 4, 3, target, heads=2,
                        in_channels=32), (x_dict, ei_dict),
            lambda: {"plan_dict": common.synthetic_hetero(1)[0].csr_plans()})


@pytest.mark.parametrize("kind", ["edge_split", "block_pair", "hybrid",
                                  "plan_dict"])
def test_export_leaves_the_plan_unpoisoned(kind):
    """After an export the same plan's eager calls are bitwise what they
    were and a second export works; a plan exported before any eager call
    caches real tensors only."""
    model, inputs, make_kw = _unpoisoned_case(kind)
    model.eval()
    tin = tuple(_tensors(a) for a in inputs)
    kw = make_kw()
    with torch.no_grad():
        first = model(*tin, **kw)
    for _ in range(2):
        export_forward(model, inputs, device="cpu", **kw)
        with torch.no_grad():
            assert torch.equal(model(*tin, **kw), first)
    fresh = make_kw()
    ep = export_forward(model, inputs, device="cpu", **fresh)
    plans = _caches_of(next(iter(fresh.values())))
    cached = [t for p in plans for v in p._placed.values() for t in v
              if isinstance(t, torch.Tensor)]
    assert cached and all(type(t) is torch.Tensor for t in cached)
    with torch.no_grad():
        assert torch.equal(model(*tin, **fresh), first)
        assert torch.equal(ep.module()(*tin), first)
