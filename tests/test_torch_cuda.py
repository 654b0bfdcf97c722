"""Card-only tests of the port: the CSR SpMM (and per-edge segment sum,
the accumulating form, hub rows cut into work items and their fold),
flash attention (the forward's cut rows and their fold at every lane
layout), destination expand, SDDMM, segment max and HGT attention
kernels against their plain versions, forward and backward, the launch
counts, the wrappers' checks, gradients of GCN, GAT, GATv2 and HGT
through the kernels, and the serving paths (GraphSAGE and HGT too); the
CSR-order softmax and multi-head SpMM, HAN's relations between node
types (ROADMAP C14), RGCN and SimpleHGN, and the propagation zoo
(SGC, APPNP, GCNII, JKNet, ChebNet, MixHop, GPR-GNN, FAGCN, AGNN) on its
plan route against their plain paths; the wave-2 convs (COO) on the card
against the CPU, and the han twin on IMDB's files with its plan route
against its COO route; the sampled path (GraphSAGESampleModel on padded
blocks against the CPU, the feature cache's cold rows through pinned
memory, prefetching on a side stream, a card session called from the
MicroBatcher's worker thread).

Every test is marked ``cuda`` and skips without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, elementwise, |kernel - plain| <= rtol*|plain| + 1e-5*max|plain|
(the second term for the two f32 summation orders): f32 rtol 1e-5; bf16
rtol 1e-2, one bf16 ulp, since both round once from f32. The segment max
and its per-edge cotangents: bitwise. Model
gradients through the kernels against the plain path, f32: 1e-4 of each
parameter's max |grad| (the paths form scores and sums in other orders).
"""

import copy
import inspect

import numpy as np
import pytest
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples.common import synthetic_hetero
from gammagl_tpu_torch.models import (GATModel, GATV2Model, GCNModel,
                                      GraphSAGEModel, HGTModel)
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda.sddmm_csr import (EDGE_SPLIT, _edge_items,
                                                   _expand, _sddmm)
from gammagl_tpu_torch.serve import InferenceSession
from gammagl_tpu_torch.utils import compute_dtype

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plan(seed=0, n_dst=300, n_src=420, e=4000):
    rng = np.random.default_rng(seed)
    dst = 2 * rng.integers(0, n_dst // 3, e)  # odd rows and the tail: empty
    src = rng.integers(0, n_src, e)
    return kops.build_csr_plan(src, dst, n_dst, num_src=n_src), e


def _close(got, want, rtol):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * scale)


@pytest.mark.parametrize("F", [1, 7, 40, 128, 256, 300])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("weights", ["none", "given", "padded"])
def test_kernel_matches_plain(card, F, dtype, rtol, weights):
    plan, e = _plan(F)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(plan.num_src, F, generator=g).to(card, dtype)
    w = None if weights == "none" else torch.rand(e, generator=g).to(card)
    if weights == "padded":
        w = kops.pad_edge_weights(plan, w)
    padded = weights == "padded"
    before = kops.spmm_csr.launches
    got = kops.spmm_csr(x, w, plan, weights_padded=padded)
    torch.cuda.synchronize()
    assert kops.spmm_csr.launches == before + 1
    assert got.dtype == dtype and got.shape == (plan.num_nodes, F)
    _close(got, kops.spmm_csr_reference(x, w, plan, weights_padded=padded),
           rtol)
    # deterministic: no atomics, a fixed edge order within each row
    assert torch.equal(got, kops.spmm_csr(x, w, plan, weights_padded=padded))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_no_edges_and_misaligned_x(card, dtype):
    none = np.zeros(0, np.int64)
    empty = kops.build_csr_plan(none, none, 33, num_src=5)
    out = kops.spmm_csr(torch.ones(5, 40, device=card, dtype=dtype),
                        torch.zeros(0, device=card), empty)
    torch.cuda.synchronize()
    assert bool((out == 0).all()) and out.shape == (33, 40)
    plan, e = _plan(1)
    flat = torch.randn(plan.num_src * 64 + 1, device=card).to(dtype)
    x = flat[1:].view(plan.num_src, 64)  # 16-byte loads not allowed
    w = torch.rand(e, device=card)
    _close(kops.spmm_csr(x, w, plan), kops.spmm_csr_reference(x, w, plan),
           1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    plan, e = _plan(2)
    x = torch.randn(plan.num_src, 16, device=card)
    with pytest.raises(TypeError, match="dtype"):
        kops.spmm_csr(x.half(), None, plan)
    with pytest.raises(ValueError, match="contiguous"):
        kops.spmm_csr(torch.randn(16, plan.num_src, device=card).t(),
                      None, plan)
    with pytest.raises(ValueError, match="edge weights on cpu"):
        kops.spmm_csr(x, torch.rand(e), plan, weights_padded=True)


def test_session_on_card_matches_cpu_session(card):
    rng = np.random.default_rng(3)
    n, e = 2000, 16000
    x = rng.normal(size=(n, 48)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    model = GCNModel(hidden_dim=64, num_class=7, num_layers=3,
                     dtype=torch.bfloat16)
    cpu = InferenceSession(model, (x, graph.edge_index), device="cpu",
                           compute_dtype=torch.bfloat16,
                           plan=graph.csr_plan())
    want = cpu(x, graph.edge_index)
    gpu = InferenceSession(model, (x, graph.edge_index), device="cuda",
                           compute_dtype=torch.bfloat16,
                           plan=graph.csr_plan())
    before = kops.spmm_csr.launches
    got = gpu(x, graph.edge_index)
    torch.cuda.synchronize()
    assert kops.spmm_csr.launches == before + 3
    assert got.device.type == "cuda" and got.shape == (n, 7)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=3e-2 * scale)


def _flash_case(card, H, F, dtype, gather, keep, seed=0, plan=None):
    if plan is None:
        plan, _ = _plan(seed)
    g = torch.Generator().manual_seed(seed)
    rows = plan.num_src if gather else plan.num_edges
    s = torch.randn(rows, H, generator=g).to(card)
    a = torch.randn(plan.num_nodes, H, generator=g).to(card)
    msg = torch.randn(rows, H * F, generator=g).to(card, dtype)
    kp = None
    if keep:
        kp = ((torch.rand(plan.num_edges, H, generator=g) < 0.4).float()
              / 0.4).to(card)
    grad = torch.randn(plan.num_nodes, H * F, generator=g).to(card, dtype)
    return plan, (s, a, msg, kp), grad


def _flash_both(plan, inputs, grad, gather, fn_fwd, fn_bwd, saved=None):
    """Forward, then backward from ``saved`` (out, m, l) when given (the
    plain backward takes the kernel's: a bf16 ``out`` rounded otherwise
    shifts c = <out, g> by an ulp), else from this forward."""
    s, a, msg, kp = inputs
    out, m, l = fn_fwd(s, a, msg, kp, plan, 0.2, gather)
    b_out, b_m, b_l = saved if saved is not None else (out, m, l)
    ds, dmsg, da = fn_bwd(s, a, msg, kp, b_m, b_l, b_out, grad, plan, 0.2,
                          gather)
    return out, m, l, ds, dmsg, da


@pytest.mark.parametrize("H,F", [(8, 8), (1, 40), (1, 64), (4, 64), (2, 640),
                                 (3, 5)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("keep", [False, True])
def test_flash_kernels_match_plain(card, H, F, dtype, rtol, gather, keep):
    plan, inputs, grad = _flash_case(card, H, F, dtype, gather, keep, seed=H)
    before = (kops.flash_forward.launches, kops.flash_backward.launches)
    got = _flash_both(plan, inputs, grad, gather, kops.flash_forward,
                      kops.flash_backward)
    torch.cuda.synchronize()
    assert (kops.flash_forward.launches,
            kops.flash_backward.launches) == (before[0] + 1, before[1] + 1)
    want = _flash_both(plan, inputs, grad, gather,
                       kops.flash_forward_reference,
                       kops.flash_backward_reference, saved=got[:3])
    out, m, l, ds, dmsg, da = got
    assert out.dtype == dtype and dmsg.dtype == dtype
    assert torch.equal(m, want[1])
    for g_, w_, r in zip(got, want, (rtol, 0, 1e-5, 1e-5, rtol, 1e-5)):
        _close(g_, w_, r)
    # empty rows: exactly 0 out and da, the JAX kernel's (m, l)
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((out[empty] == 0).all()) and bool((da[empty] == 0).all())
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    # deterministic: no atomics, a fixed edge order within each row
    again = _flash_both(plan, inputs, grad, gather, kops.flash_forward,
                        kops.flash_backward)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("H,F", [(8, 8), (1, 40), (4, 64), (2, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_read_keep_in_caller_order(card, dtype, H, F):
    """With node rows (gather) the kernels read keep in the caller's edge
    order through the plan's perm: the same function as per-edge inputs
    gathered at each edge's source with the mask in CSR order."""
    plan, (s, a, msg, caller), grad = _flash_case(card, H, F, dtype, True,
                                                  True, seed=5)
    _, col, perm = plan.arrays(card)
    col = col.long()
    got = _flash_both(plan, (s, a, msg, caller), grad, True,
                      kops.flash_forward, kops.flash_backward)
    want = _flash_both(plan, (s[col], a, msg[col], caller[perm]), grad,
                       False, kops.flash_forward, kops.flash_backward,
                       saved=got[:3])
    torch.cuda.synchronize()
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for g_, w_, r in zip(got, want, (rt, 0, 1e-5, 1e-5, rt, 1e-5)):
        _close(g_, w_, r)
    plain = _flash_both(plan, (s, a, msg, caller), grad, True,
                        kops.flash_forward_reference,
                        kops.flash_backward_reference, saved=got[:3])
    for g_, w_, r in zip(got, plain, (rt, 0, 1e-5, 1e-5, rt, 1e-5)):
        _close(g_, w_, r)


@pytest.mark.parametrize("H,F", [(8, 8), (1, 40), (4, 64)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_flash_backward_on_rows_of_every_length(card, H, F, dtype, rtol):
    """Rows of 0 to 3,000 edges (the backward's groups take a row's edges
    in turn and add their partial da in group order): the plain version's
    values, and the same bits on a second run."""
    rng = np.random.default_rng(H * F)
    deg = np.concatenate([[3000, 257, 33], rng.integers(0, 12, 200)])
    dst = np.repeat(np.arange(deg.size), deg)
    plan = kops.build_csr_plan(rng.integers(0, 500, dst.size), dst,
                               deg.size, num_src=500)
    _, inputs, grad = _flash_case(card, H, F, dtype, False, True, plan=plan)
    got = _flash_both(plan, inputs, grad, False, kops.flash_forward,
                      kops.flash_backward)
    want = _flash_both(plan, inputs, grad, False,
                       kops.flash_forward_reference,
                       kops.flash_backward_reference, saved=got[:3])
    for g_, w_, r in zip(got[3:], want[3:], (1e-5, rtol, 1e-5)):
        _close(g_, w_, r)
    again = kops.flash_backward(*inputs, *got[1:3], got[0], grad, plan, 0.2,
                                False)
    assert all(torch.equal(x, y) for x, y in zip(got[3:], again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_without_edges(card, dtype):
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 33, num_src=5)
    _, inputs, grad = _flash_case(card, 2, 8, dtype, True, True, plan=plan)
    out, m, l, ds, dmsg, da = _flash_both(plan, inputs, grad, True,
                                          kops.flash_forward,
                                          kops.flash_backward)
    torch.cuda.synchronize()
    assert out.shape == (33, 16) and bool((out == 0).all())
    assert ds.shape == (0, 2) and dmsg.shape == (0, 16)
    assert bool((da == 0).all()) and bool((l == 0).all())


# (H, F) of rows that reach every (V, L) layout the flash forward
# dispatches (launch_fwd in csrc/flash_attention.cu), in f32 and bf16:
# every V, groups of 1 to 32 lanes, and rows wider than 32 V (column
# chunks)
_FLASH_LAYOUT_SHAPES = {
    torch.bfloat16: [(1, 8), (2, 8), (4, 8), (8, 8), (1, 40), (1, 64),
                     (2, 64), (4, 64), (2, 640), (1, 4), (3, 12), (1, 6),
                     (3, 5), (1, 1)],
    torch.float32: [(1, 4), (2, 8), (8, 8), (1, 40), (1, 64), (4, 64),
                    (2, 640), (1, 6), (3, 5)]}
_FLASH_LAYOUT_CASES = [(dt, 1e-2 if dt == torch.bfloat16 else 1e-5, H, F)
                       for dt, shapes in _FLASH_LAYOUT_SHAPES.items()
                       for H, F in shapes]


def _flash_layout(H, F, dtype):
    """(V, L, column chunks) of the flash forward for aligned rows: V the
    widest of 16 bytes that divides F (a lane's columns lie in one head),
    L the power of two >= H*F / V, at most 32 (`lanes_log2`)."""
    v = 16 // (torch.finfo(dtype).bits // 8)
    while F % v:
        v //= 2
    L = 1
    while L < 32 and L * v < H * F:
        L *= 2
    return v, L, -(-H * F // (L * v))


def test_flash_shapes_reach_every_dispatched_layout(card):
    for dtype, shapes in _FLASH_LAYOUT_SHAPES.items():
        got = {_flash_layout(H, F, dtype) for H, F in shapes}
        vs = (1, 2, 4, 8) if dtype == torch.bfloat16 else (1, 2, 4)
        assert {v for v, _, _ in got} == set(vs)
        assert {L for _, L, _ in got} >= ({1, 4, 16, 32} if dtype ==
                                          torch.float32 else
                                          {1, 2, 4, 8, 16, 32})
        assert max(c for _, _, c in got) > 1


@pytest.mark.parametrize("dtype,rtol,H,F", _FLASH_LAYOUT_CASES)
@pytest.mark.parametrize("gather", [False, True])
def test_flash_forward_cut_rows_at_every_layout(card, dtype, rtol, H, F,
                                                gather):
    """A star of 5,000 edges cut into 3 work items at ROW_SPLIT, its
    partials merged by the fold: one launch and one fold a forward; out,
    m and l against the plain version (m bitwise), the backward from them
    against its plain version, empty rows exact, a repeat bitwise equal;
    keep in the caller's order with gathered rows, in CSR order else."""
    plan = _hub_plan(H * F, star=5000)
    assert plan.row_split().cut_row.tolist() == [0]
    _, inputs, grad = _flash_case(card, H, F, dtype, gather, True,
                                  seed=H * F, plan=plan)
    before = (kops.flash_forward.launches, kops.flash_fwd_fold.launches)
    got = _flash_both(plan, inputs, grad, gather, kops.flash_forward,
                      kops.flash_backward)
    torch.cuda.synchronize()
    assert (kops.flash_forward.launches - before[0],
            kops.flash_fwd_fold.launches - before[1]) == (1, 1)
    want = _flash_both(plan, inputs, grad, gather,
                       kops.flash_forward_reference,
                       kops.flash_backward_reference, saved=got[:3])
    out, m, l, _, _, da = got
    assert torch.equal(m, want[1])
    for g_, w_, r in zip(got, want, (rtol, 0, 1e-5, 1e-5, rtol, 1e-5)):
        _close(g_, w_, r)
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((out[empty] == 0).all()) and bool((da[empty] == 0).all())
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    again = _flash_both(plan, inputs, grad, gather, kops.flash_forward,
                        kops.flash_backward)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_fold_runs_exactly_when_a_plan_has_cut_rows(card):
    for plan, cut in ((_plan(7)[0], False), (_hub_plan(7, star=5000), True)):
        assert bool(plan.row_split().cut_row.size) == cut
        _, (s, a, msg, kp), _ = _flash_case(card, 8, 8, torch.bfloat16, True,
                                            True, plan=plan)
        before = kops.flash_fwd_fold.launches
        kops.flash_forward(s, a, msg, kp, plan, 0.2, True)
        torch.cuda.synchronize()
        assert kops.flash_fwd_fold.launches - before == (1 if cut else 0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(card):
    plan, (s, a, msg, kp), _ = _flash_case(card, 2, 8, torch.float32, True,
                                           False)
    with pytest.raises(TypeError, match="dtype"):
        kops.flash_forward(s, a, msg.half(), None, plan, 0.2, True)
    with pytest.raises(TypeError, match="float32"):
        kops.flash_forward(s.double(), a, msg, None, plan, 0.2, True)
    with pytest.raises(ValueError, match="inputs on cpu"):
        kops.flash_forward(s, a.cpu(), msg, None, plan, 0.2, True)


def _gcn_grads(model, x, ei, plan):
    model.zero_grad()
    out = model(x, ei, plan=plan)
    torch.nn.functional.cross_entropy(
        out.float(), torch.arange(x.shape[0], device=x.device) % 7).backward()
    return out.detach(), [p.grad for p in model.parameters()]


def test_gcn_gradients_through_the_kernel_match_the_plain_path(card):
    """spmm_csr on a CUDA tensor is differentiable: every weight of a
    GCNModel with a plan gets the gradient of the plain COO path (before
    the SpMM backward existed, all but the last bias got none)."""
    rng = np.random.default_rng(7)
    n, e = 1500, 12000
    x = rng.normal(size=(n, 32)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    model = GCNModel(hidden_dim=48, num_class=7, num_layers=3,
                     drop_rate=0.0).to(card)
    xt = torch.tensor(x, device=card)
    ei = torch.tensor(graph.edge_index, device=card)
    want_out, want = _gcn_grads(model, xt, ei, None)
    before = kops.spmm_csr.launches
    got_out, got = _gcn_grads(model, xt, ei, graph.csr_plan())
    torch.cuda.synchronize()
    # 3 forward launches and 3 dx launches: each layer's SpMM input is
    # its projected features, which need a gradient
    assert kops.spmm_csr.launches == before + 6
    _close(got_out, want_out, 1e-5)
    for g_, w_ in zip(got, want):
        assert g_ is not None and bool((g_ != 0).any())
        torch.testing.assert_close(g_, w_, rtol=0,
                                   atol=1e-4 * float(w_.abs().max()))


def test_gat_training_through_the_kernels_matches_the_plain_path(card):
    """A GATModel step in training mode, f32: the plan path (flash
    kernels forward and backward, SpMM for the feature gradients) against
    the COO path with the same keep masks and dropout generator state."""
    rng = np.random.default_rng(8)
    n, e = 1200, 9000
    x = rng.normal(size=(n, 24)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    xt = torch.tensor(x, device=card)
    ei = torch.tensor(graph.edge_index, device=card)
    E = ei.shape[1]
    g = torch.Generator(device=card).manual_seed(9)
    keeps = [kops.attention_keep_mask(g, 0.6, (E, h), card) for h in (4, 1)]
    torch.manual_seed(10)
    base = GATModel(hidden_dim=8, num_class=5, heads=4, in_channels=24)
    y = torch.arange(n, device=card) % 5
    results = []
    for plan in (graph.csr_plan(), None):
        model = copy.deepcopy(base).to(card).train()
        gen = torch.Generator(device=card).manual_seed(11)
        before = (kops.flash_forward.launches, kops.flash_backward.launches,
                  kops.spmm_csr.launches)
        out = model(xt, ei, plan=plan, keeps=keeps, generator=gen)
        torch.nn.functional.cross_entropy(out, y).backward()
        torch.cuda.synchronize()
        after = (kops.flash_forward.launches, kops.flash_backward.launches,
                 kops.spmm_csr.launches)
        # each gathered backward: the score's and the features' SpMM on
        # the edge-scatter plan (ROADMAP C39)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (2, 2, 4) if plan is not None else (0, 0, 0))
        results.append((out.detach(), [p.grad for p in model.parameters()]))
    (out_k, grads_k), (out_p, grads_p) = results
    _close(out_k, out_p, 1e-4)
    for g_, w_ in zip(grads_k, grads_p):
        torch.testing.assert_close(g_, w_, rtol=0,
                                   atol=1e-4 * float(w_.abs().max()))


def _gat_step_grads(card, model, xt, ei, plan, keeps, y, seed):
    model.zero_grad()
    gen = torch.Generator(device=card).manual_seed(seed)
    out = model(xt, ei, plan=plan, keeps=keeps, generator=gen)
    loss = torch.nn.functional.cross_entropy(out, y)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathered_flash_backward_repeats_bitwise_c39(card, dtype):
    """ROADMAP C39: a GAT step (8 heads x 8, then 1 x 5: the gathered
    backward at H = 8 and at H = 1) on a graph whose sources feed
    thousands of edges each, run twice from the same parameters, masks
    and generator state: the loss and every gradient bitwise equal. Then
    `flash_gat_attention` on a plan with no edges: zero gradients, twice
    bitwise, and the backward's two SpMM launches."""
    rng = np.random.default_rng(40)
    n, e = 3000, 60000
    src = rng.integers(0, 40, e)  # 40 hub sources
    x = rng.normal(size=(n, 24)).astype(np.float32)
    graph = Graph(x=x, edge_index=np.stack(
        [src, rng.integers(0, n, e)])).add_self_loop()
    xt = torch.tensor(x, device=card)
    ei = torch.tensor(graph.edge_index, device=card)
    g = torch.Generator(device=card).manual_seed(41)
    keeps = [kops.attention_keep_mask(g, 0.6, (ei.shape[1], h), card)
             for h in (8, 1)]
    torch.manual_seed(42)
    model = GATModel(hidden_dim=8, num_class=5, heads=8, dtype=dtype,
                     in_channels=24).to(card).train()
    y = torch.arange(n, device=card) % 5
    plan = graph.csr_plan()
    before = kops.spmm_csr.launches
    (la, ga), (lb, gb) = [_gat_step_grads(card, model, xt, ei, plan, keeps,
                                          y, 43) for _ in range(2)]
    assert kops.spmm_csr.launches - before == 2 * 4
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)

    empty = kops.build_csr_plan([], [], 6, num_src=5)
    grads = []
    for _ in range(2):
        leaves = [torch.randn(5, 8, device=card, generator=g.manual_seed(7)),
                  torch.randn(6, 8, device=card),
                  torch.randn(5, 8, 4, device=card)]
        leaves = [t.to(dtype if i == 2 else torch.float32).requires_grad_()
                  for i, t in enumerate(leaves)]
        before = kops.spmm_csr.launches
        out = kops.flash_gat_attention(leaves[0], leaves[1], leaves[2], empty)
        out.float().sum().backward()
        torch.cuda.synchronize()
        assert kops.spmm_csr.launches - before == 2
        assert not out.any()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b) and not a.any()


def test_gat_session_on_card_matches_the_plain_path(card):
    rng = np.random.default_rng(12)
    n, e = 2000, 16000
    x = rng.normal(size=(n, 48)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    model = GATModel(hidden_dim=8, num_class=7, heads=8,
                     dtype=torch.bfloat16, in_channels=48)
    sess = InferenceSession(model, (x, graph.edge_index), device="cuda",
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    before = kops.flash_forward.launches
    got = sess(x, graph.edge_index)
    torch.cuda.synchronize()
    assert kops.flash_forward.launches == before + 2
    with torch.inference_mode():
        want = sess.model(torch.tensor(x, device=card).bfloat16(),
                          torch.tensor(graph.edge_index, device=card))
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=3e-2 * scale)


# heads of each width in the edge-endpoint tests: one column a head, one
# head, and GATv2's first layer
_HEADS = {7: 7, 40: 1, 64: 8}


# (C, H) of the expand's tests: the widths above, rows narrower than a
# 16-byte chunk (C = 1; 7 and 13, whose rows are no multiple of 16 bytes),
# heads narrower than a chunk (16, 8), and RGCN's class width (349: rows
# of 1396 bytes in f32) with a head a column and with one head
_EXPAND_WIDTHS = [(1, 1), (7, 7), (13, 1), (16, 8), (40, 1), (64, 8),
                  (349, 349), (349, 1)]


def _expand_checks(x, plan, scale, rtol):
    """The copy and the scaled expand on the card: each call one launch,
    the copy bitwise x[row(e)], the scaled form within ``rtol`` of the
    plain version, and a repeat of each bitwise equal."""
    before = kops.expand_dst_csr.launches
    got = kops.expand_dst_csr(x, plan)
    torch.cuda.synchronize()
    assert kops.expand_dst_csr.launches == before + 1
    scaled = _expand(x, plan, scale)
    torch.cuda.synchronize()
    assert kops.expand_dst_csr.launches == before + 2
    assert got.dtype == x.dtype and got.shape == (plan.num_edges, x.shape[1])
    assert torch.equal(got, kops.expand_dst_csr_reference(x, plan))
    _close(scaled, kops.expand_dst_csr_reference(x, plan, scale), rtol)
    assert torch.equal(got, kops.expand_dst_csr(x, plan))
    assert torch.equal(scaled, _expand(x, plan, scale))


@pytest.mark.parametrize("C,H", _EXPAND_WIDTHS)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_expand_kernel_matches_plain(card, C, H, dtype, rtol):
    """Unscaled, the expand is a copy: bitwise equal to x[row(e)]. Scaled
    per edge and head, one f32 product rounded once. Where C elements are
    no multiple of 16 bytes, most items' output runs start off a 16-byte
    boundary, so the scalar prologue and epilogue run."""
    plan, e = _plan(C)
    g = torch.Generator().manual_seed(C)
    x = torch.randn(plan.num_nodes, C, generator=g).to(card, dtype)
    scale = torch.randn(e, H, generator=g).to(card)
    _expand_checks(x, plan, scale, rtol)


@pytest.mark.parametrize("C,H", [(7, 7), (64, 8), (349, 1)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", ["misaligned x", "hub"])
def test_expand_misaligned_x_and_hub_rows(card, C, H, dtype, rtol, case):
    """``misaligned x``: rows read from a flat buffer sliced from element
    1 (x off 16 bytes, so no width takes the aligned instance). ``hub``:
    a star of 20,000 edges into row 0, more than 10 x EDGE_SPLIT, cut
    into work items, beside rows with no edges. Same checks as above."""
    if case == "hub":
        plan = _hub_plan(C)
        assert 0 in plan.row_split(EDGE_SPLIT).cut_row.tolist()
        assert 20_000 > 10 * EDGE_SPLIT
    else:
        plan, _ = _plan(C + 1)
    assert (np.diff(plan.rowptr) == 0).any()
    g = torch.Generator().manual_seed(C + 2)
    if case == "hub":
        x = torch.randn(plan.num_nodes, C, generator=g).to(card, dtype)
    else:
        flat = torch.randn(plan.num_nodes * C + 1, generator=g).to(card,
                                                                   dtype)
        x = flat[1:].view(plan.num_nodes, C)
        assert x.data_ptr() % 16
    scale = torch.randn(plan.num_edges, H, generator=g).to(card)
    _expand_checks(x, plan, scale, rtol)


@pytest.mark.parametrize("C", sorted(_HEADS))
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("weights", ["unit", "edge", "head"])
def test_segment_sum_kernel_matches_plain(card, C, dtype, rtol, weights):
    plan, e = _plan(C + 1)
    g = torch.Generator().manual_seed(C)
    v = torch.randn(e, C, generator=g).to(card, dtype)
    w = {"unit": None, "edge": torch.rand(e, generator=g),
         "head": torch.rand(e, _HEADS[C], generator=g)}[weights]
    w = None if w is None else w.to(card)
    before = kops.segment_sum_csr.launches
    got = kops.segment_sum_csr(v, plan, w)
    torch.cuda.synchronize()
    assert kops.segment_sum_csr.launches == before + 1
    assert got.dtype == dtype and got.shape == (plan.num_nodes, C)
    _close(got, kops.segment_sum_csr_reference(v, plan, w), rtol)
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((got[empty] == 0).all())
    assert torch.equal(got, kops.segment_sum_csr(v, plan, w))


@pytest.mark.parametrize("H,F", [(1, 7), (8, 8), (1, 40), (1, 256),
                                 (2, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gather", [False, True])
def test_sddmm_kernel_matches_plain(card, H, F, dtype, gather):
    """f32 dots of the same products, summed in another order: 1e-5."""
    plan, e = _plan(F)
    g = torch.Generator().manual_seed(F)
    rows = plan.num_src if gather else e
    a = torch.randn(rows, H * F, generator=g).to(card, dtype)
    xd = torch.randn(plan.num_nodes, H * F, generator=g).to(card, dtype)
    before = kops.sddmm_csr.launches
    got = _sddmm(a, xd, plan, H, gather)
    torch.cuda.synchronize()
    assert kops.sddmm_csr.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (e, H)
    _close(got, kops.sddmm_csr_reference(a, xd, plan, H, gather), 1e-5)
    assert torch.equal(got, _sddmm(a, xd, plan, H, gather))


@pytest.mark.parametrize("H,F", [(1, 7), (8, 8), (1, 40), (1, 256),
                                 (2, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gather", [False, True])
def test_sddmm_hub_rows_are_cut_into_items(card, H, F, dtype, gather):
    """A row of 20,000 edges, cut into work items at EDGE_SPLIT: one
    launch a call and no fold, 1e-5 against the plain version (f32 dots),
    repeats bitwise equal."""
    plan = _hub_plan(H * F)
    assert 0 in plan.row_split(EDGE_SPLIT).cut_row.tolist()
    g = torch.Generator().manual_seed(H * F)
    rows = plan.num_src if gather else plan.num_edges
    a = torch.randn(rows, H * F, generator=g).to(card, dtype)
    xd = torch.randn(plan.num_nodes, H * F, generator=g).to(card, dtype)
    before, folds = kops.sddmm_csr.launches, kops.csr_fold.launches
    got = _sddmm(a, xd, plan, H, gather)
    torch.cuda.synchronize()
    assert kops.sddmm_csr.launches == before + 1
    assert kops.csr_fold.launches == folds
    assert got.dtype == torch.float32 and got.shape == (plan.num_edges, H)
    _close(got, kops.sddmm_csr_reference(a, xd, plan, H, gather), 1e-5)
    assert torch.equal(got, _sddmm(a, xd, plan, H, gather))


@pytest.mark.parametrize("H,F", [(8, 8), (1, 256), (2, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("gather", [False, True])
def test_sddmm_misaligned_rows(card, H, F, dtype, offset, gather):
    """Rows that start ``offset`` elements past an aligned address (a row
    slice of a flat table): the kernel takes a narrower load and still
    matches the plain version at 1e-5."""
    plan, e = _plan(F + offset)
    g = torch.Generator().manual_seed(F + offset)
    rows = plan.num_src if gather else e

    def table(n):
        flat = torch.randn(n * H * F + offset, generator=g).to(card, dtype)
        return flat[offset:].view(n, H * F)

    a, xd = table(rows), table(plan.num_nodes)
    assert a.data_ptr() % 16 and xd.data_ptr() % 16
    got = _sddmm(a, xd, plan, H, gather)
    torch.cuda.synchronize()
    _close(got, kops.sddmm_csr_reference(a, xd, plan, H, gather), 1e-5)
    assert torch.equal(got, _sddmm(a, xd, plan, H, gather))


def _edge_op_cases(plan, e, g):
    """name -> (fn, feature inputs, f32 weight inputs, launches of
    (expand, segment sum, sddmm, spmm) for one forward and backward)."""
    H, F = 2, 8
    xs = torch.randn(plan.num_src, H, F, generator=g)
    xd = torch.randn(plan.num_nodes, H, F, generator=g)
    msg = torch.randn(e, H, F, generator=g)
    w = torch.rand(e, H, generator=g)
    return {
        "expand": (lambda x: kops.expand_dst_csr(x, plan), (xd,), (),
                   (1, 1, 0, 0)),
        "segment_sum": (lambda v, w: kops.segment_sum_csr(v, plan, w),
                        (msg.reshape(e, H * F),), (w,), (1, 1, 1, 0)),
        "sddmm": (lambda a, b: kops.sddmm_csr_mh(a, b, plan), (xs, xd), (),
                  (0, 0, 1, 2)),
        "sddmm_msg": (lambda m, b: kops.sddmm_csr_mh(None, b, plan, msg=m),
                      (msg, xd), (), (1, 1, 1, 0)),
        "sddmm_single": (lambda a, b: kops.sddmm_csr(a, b, plan),
                         (xs[:, 0], xd[:, 0]), (), (0, 0, 1, 2)),
        "gather_src": (lambda x: kops.gather_rows(x, plan, "src"), (xs,), (),
                       (0, 0, 0, 1)),
    }


def _counts():
    return (kops.expand_dst_csr.launches, kops.segment_sum_csr.launches,
            kops.sddmm_csr.launches, kops.spmm_csr.launches)


@pytest.mark.parametrize("op", ["expand", "segment_sum", "sddmm",
                                "sddmm_msg", "sddmm_single", "gather_src"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_edge_op_gradients_match_the_plain_version(card, op, dtype, rtol):
    """Each autograd op forward and backward on the card (kernels only)
    against the same op on the CPU (plain versions), same inputs."""
    plan, e = _plan(11)
    g = torch.Generator().manual_seed(11)
    fn, feats, weights, launches = _edge_op_cases(plan, e, g)[op]
    results = []
    for dev in ("cpu", card):
        args = ([t.clone().to(dev, dtype).requires_grad_() for t in feats]
                + [t.clone().to(dev).requires_grad_() for t in weights])
        before = _counts()
        out = fn(*args)
        cot = torch.randn(out.shape, generator=torch.Generator()
                          .manual_seed(12)).to(dev)
        (out.float() * cot).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_counts(), before)) == launches
        results.append([out.detach()] + [a.grad for a in args])
    for got, want in zip(results[1], results[0]):
        _close(got, want, rtol)


def test_edge_ops_without_edges(card):
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 33, num_src=5)
    x = torch.randn(33, 16, device=card)
    assert kops.expand_dst_csr(x, plan).shape == (0, 16)
    out = kops.segment_sum_csr(torch.zeros(0, 16, device=card), plan)
    assert out.shape == (33, 16) and bool((out == 0).all())
    s = kops.sddmm_csr_mh(torch.randn(5, 2, 8, device=card),
                          x.view(33, 2, 8), plan)
    torch.cuda.synchronize()
    assert s.shape == (0, 2)


def test_edge_op_wrappers_reject_what_the_kernels_do_not_take(card):
    plan, e = _plan(13)
    x = torch.randn(plan.num_nodes, 16, device=card)
    with pytest.raises(TypeError, match="dtype"):
        kops.expand_dst_csr(x.half(), plan)
    with pytest.raises(ValueError, match="inputs on"):
        _sddmm(torch.randn(plan.num_src, 16), x, plan, 1, True)
    with pytest.raises(TypeError, match="float32"):
        _expand(x, plan, torch.ones(e, 2, device=card).double())


def _gatv2_setup(card, seed, n, e, f_in):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    return (graph, torch.tensor(x, device=card),
            torch.tensor(graph.edge_index, device=card))


@pytest.mark.parametrize("share_weights", [False, True])
def test_gatv2_training_through_the_kernels_matches_the_plain_path(
        card, share_weights):
    """A GATV2Model step in training mode, f32: the plan path (expand and
    flash kernels forward; flash, segment sum and SpMM kernels backward)
    against the COO path. One generator state gives both paths the same
    input dropout and the same attention masks, drawn in CSR order."""
    graph, xt, ei = _gatv2_setup(card, 14, 1200, 9000, 24)
    torch.manual_seed(15)
    base = GATV2Model(hidden_dim=8, num_class=5, heads=4, in_channels=24)
    if share_weights:
        for conv in base.convs:
            conv.lin_r = None
            conv.share_weights = True
    y = torch.arange(xt.shape[0], device=card) % 5
    results = []
    for plan in (graph.csr_plan(), None):
        model = copy.deepcopy(base).to(card).train()
        gen = torch.Generator(device=card).manual_seed(16)
        before = _counts() + (kops.flash_forward.launches,
                              kops.flash_backward.launches)
        out = model(xt, ei, plan=plan, generator=gen)
        torch.nn.functional.cross_entropy(out, y).backward()
        torch.cuda.synchronize()
        after = _counts() + (kops.flash_forward.launches,
                             kops.flash_backward.launches)
        # expand, segment sum, sddmm, spmm, flash forward, flash backward
        assert tuple(a - b for a, b in zip(after, before)) == (
            (2, 2, 0, 2, 2, 2) if plan is not None else (0,) * 6)
        results.append((out.detach(), [p.grad for p in model.parameters()]))
    (out_k, grads_k), (out_p, grads_p) = results
    _close(out_k, out_p, 1e-4)
    for g_, w_ in zip(grads_k, grads_p):
        torch.testing.assert_close(g_, w_, rtol=0,
                                   atol=1e-4 * float(w_.abs().max()))


def test_gatv2_session_on_card_matches_the_plain_path(card):
    graph, xt, ei = _gatv2_setup(card, 17, 2000, 16000, 48)
    model = GATV2Model(hidden_dim=8, num_class=7, heads=8, in_channels=48)
    with compute_dtype(torch.bfloat16):
        sess = InferenceSession(model, (graph.x, graph.edge_index),
                                compute_dtype=torch.bfloat16,
                                plan=graph.csr_plan())
        before = (kops.expand_dst_csr.launches, kops.flash_forward.launches)
        got = sess(graph.x, graph.edge_index)
        torch.cuda.synchronize()
        assert (kops.expand_dst_csr.launches,
                kops.flash_forward.launches) == (before[0] + 2, before[1] + 2)
        with torch.inference_mode():
            want = sess.model(xt.bfloat16(), ei)
    assert sess.device.type == "cuda" and got.shape == (2000, 7)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=3e-2 * scale)


@pytest.mark.parametrize("F", [1, 7, 40, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_max_kernel_is_bitwise_equal_to_plain(card, F, dtype,
                                                      weighted, op):
    plan, e = _plan(F + 3)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(plan.num_src, F, generator=g).to(card, dtype)
    x[1::5] = x[0]  # ties
    w = torch.randn(e, generator=g).to(card) if weighted else None
    fn, ref = ((kops.spmm_max_csr, kops.spmm_max_csr_reference) if op == "max"
               else (kops.spmm_min_csr, kops.spmm_min_csr_reference))
    before = fn.launches
    got = fn(x, w, plan)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, ref(x, w, plan))
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((got[empty] == 0).all())
    # per-edge rows in CSR order, and the backward: per-edge cotangents
    # bitwise, ties split evenly, dw through the same kernel
    msg = x[plan.arrays(card)[1].long()]
    per_edge = (kops.segment_max_csr if op == "max"
                else kops.segment_min_csr)
    assert torch.equal(per_edge(msg, plan), ref(x, None, plan))
    wp = None if w is None else kops.pad_edge_weights(plan, w)
    gy = torch.randn(got.shape, generator=g).to(card, dtype)
    before = kops.segment_max_bwd.launches
    dmsg, dw = kops.segment_max_bwd(x, wp, got, gy, plan, False, True)
    torch.cuda.synchronize()
    assert kops.segment_max_bwd.launches == before + 1
    rdmsg, rdw = kops.segment_max_bwd_reference(x, wp, got, gy, plan, False,
                                                weighted)
    assert torch.equal(dmsg, rdmsg)
    if weighted:
        _close(dw, rdw, 1e-5)
    else:
        assert dw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_max_gradients_and_no_edges(card, dtype):
    plan, e = _plan(4)
    g = torch.Generator().manual_seed(4)
    x0 = torch.randn(plan.num_src, 40, generator=g).to(dtype)
    w0 = torch.randn(e, generator=g)
    gy = torch.randn(plan.num_nodes, 40, generator=g).to(dtype)
    grads = []
    for dev in (card, torch.device("cpu")):
        x = x0.to(dev).requires_grad_()
        w = w0.to(dev).requires_grad_()
        (kops.spmm_max_csr(x, w, plan).float() * gy.to(dev).float()
         ).sum().backward()
        grads.append((x.grad.cpu(), w.grad.cpu()))
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    _close(grads[0][0], grads[1][0], rt)
    _close(grads[0][1], grads[1][1], 1e-5)
    none = np.zeros(0, np.int64)
    empty = kops.build_csr_plan(none, none, 33, num_src=5)
    x = torch.randn(5, 8, device=card, dtype=dtype, requires_grad=True)
    out = kops.spmm_max_csr(x, None, empty)
    out.sum().backward()
    torch.cuda.synchronize()
    assert out.shape == (33, 8) and bool((out == 0).all())
    assert bool((x.grad == 0).all())


def _hgt_case(card, H, D, dtype, plan, seed=0):
    g = torch.Generator().manual_seed(seed)
    kv = torch.randn(plan.num_src, 2 * H * D, generator=g).to(card, dtype)
    q = (torch.randn(plan.num_nodes, H, D, generator=g) / D ** 0.5).to(
        card, dtype)
    gy = torch.randn(plan.num_nodes, H * D, generator=g).to(card, dtype)
    return kv, q, gy


@pytest.mark.parametrize("H,D", [(2, 64), (4, 64), (8, 32), (1, 256),
                                 (3, 5), (1, 300)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_hgt_kernels_match_plain(card, H, D, dtype, rtol):
    plan, _ = _plan(H * D)
    kv, q, gy = _hgt_case(card, H, D, dtype, plan)
    before = (kops.hgt_forward.launches, kops.hgt_backward.launches)
    out, m, l = kops.hgt_forward(kv, q, plan)
    dq, dkv = kops.hgt_backward(kv, q, out, gy, m, l, plan)
    torch.cuda.synchronize()
    assert (kops.hgt_forward.launches,
            kops.hgt_backward.launches) == (before[0] + 1, before[1] + 1)
    r_out, r_m, r_l = kops.hgt_forward_reference(kv, q, plan)
    # the plain backward from the kernel's (out, m, l)
    r_dq, r_dkv = kops.hgt_backward_reference(kv, q, out, gy, m, l, plan)
    for got, want, r in ((out, r_out, rtol), (m, r_m, 1e-5), (l, r_l, 1e-5),
                         (dq, r_dq, rtol), (dkv, r_dkv, rtol)):
        _close(got, want, r)
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((out[empty] == 0).all()) and bool((dq[empty] == 0).all())
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    again = kops.hgt_forward(kv, q, plan)[0]  # no atomics
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hgt_flash_packed_gradients_and_launches(card, dtype):
    plan, _ = _plan(9)
    kv0, q0, gy = _hgt_case(card, 4, 64, dtype, plan, seed=9)
    results = []
    for dev in (card, torch.device("cpu")):
        kv = kv0.detach().to(dev).requires_grad_()
        q = q0.detach().to(dev).requires_grad_()
        before = (kops.hgt_forward.launches, kops.hgt_backward.launches,
                  kops.spmm_csr.launches)
        out = kops.hgt_flash_packed(kv, q, plan)
        (out.float() * gy.to(dev).float()).sum().backward()
        torch.cuda.synchronize()
        after = (kops.hgt_forward.launches, kops.hgt_backward.launches,
                 kops.spmm_csr.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (1, 1, 1) if dev.type == "cuda" else (0, 0, 0))
        results.append((out.cpu(), kv.grad.cpu(), q.grad.cpu()))
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for got, want in zip(*results):
        # bf16: the backward's cotangents round once more on each device
        _close(got, want, rt if dtype == torch.float32 else 3e-2)
    none = np.zeros(0, np.int64)
    empty = kops.build_csr_plan(none, none, 6, num_src=4)
    kv, q, _ = _hgt_case(card, 2, 8, dtype, empty)
    out = kops.hgt_flash_packed(kv, q, empty)
    torch.cuda.synchronize()
    assert out.shape == (6, 16) and bool((out == 0).all())


# (H, D) of heads that reach every (V, K) layout the HGT kernels dispatch
# (GAMMAGL_HGT_DISPATCH in csrc/hetero_flash.cu), in f32 and in bf16; an
# f32 head of 520 columns takes 5 column chunks, which none serves
_HGT_LAYOUT_SHAPES = [(1, 5), (4, 10), (4, 20), (4, 64), (1, 33), (1, 65),
                      (1, 66), (1, 130), (1, 132), (1, 260), (1, 264),
                      (1, 520)]
_HGT_LAYOUT_CASES = (
    [(torch.float32, 1e-5, H, D) for H, D in _HGT_LAYOUT_SHAPES[:-1]]
    + [(torch.bfloat16, 1e-2, H, D) for H, D in _HGT_LAYOUT_SHAPES])


def _hgt_layout(H, D, dtype):
    """(V, K) that `layout_for` in csrc/hetero_flash.cu picks for aligned
    rows: the fewest (head pass x column chunk) trips, then the narrowest
    loads; K rounded up to 1, 2 or 4."""
    size = torch.finfo(dtype).bits // 8
    best = None
    for V in (1, 2, 4, 8):
        if V * size > 16 or D % V:
            continue
        per, L = -(-D // V), 1
        while L < 32 and L < per:
            L *= 2
        K = -(-D // (L * V))
        trips = K * -(-H // (32 // L))
        if best is None or trips < best[0]:
            best = (trips, V, K)
    _, V, K = best
    return V, next(k for k in (1, 2, 4) if K <= k)


def test_hgt_shapes_reach_every_dispatched_layout(card):
    for dtype in (torch.float32, torch.bfloat16):
        vs = (1, 2, 4) if dtype == torch.float32 else (1, 2, 4, 8)
        assert {_hgt_layout(H, D, dt) for dt, _, H, D in _HGT_LAYOUT_CASES
                if dt == dtype} == {(V, K) for V in vs for K in (1, 2, 4)}
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 4, num_src=4)
    kv, q, _ = _hgt_case(card, 1, 520, torch.float32, plan)
    with pytest.raises(RuntimeError, match="invalid argument"):
        kops.hgt_forward(kv, q, plan)


@pytest.mark.parametrize("dtype,rtol,H,D", _HGT_LAYOUT_CASES)
def test_hgt_forward_at_every_layout_matches_plain(card, dtype, rtol, H, D):
    """The forward's ring at each (V, K): out, m and l against the plain
    version, one launch, a repeat bitwise equal; rows of up to ~60 edges,
    longer than the ring."""
    plan, _ = _plan(H * D, e=6000)
    kv, q, _ = _hgt_case(card, H, D, dtype, plan, seed=H * D)
    before = kops.hgt_forward.launches
    out, m, l = kops.hgt_forward(kv, q, plan)
    torch.cuda.synchronize()
    assert kops.hgt_forward.launches == before + 1
    r_out, r_m, r_l = kops.hgt_forward_reference(kv, q, plan)
    for got, want, r in ((out, r_out, rtol), (m, r_m, 1e-5), (l, r_l, 1e-5)):
        _close(got, want, r)
    again = kops.hgt_forward(kv, q, plan)
    assert all(torch.equal(a, b) for a, b in zip((out, m, l), again))


@pytest.mark.parametrize("dtype,rtol,H,D", _HGT_LAYOUT_CASES)
def test_hgt_backward_at_every_layout_matches_plain(card, dtype, rtol, H,
                                                    D):
    """The backward's ring at each (V, K): dq and the per-edge dk|dv
    against the plain version from the kernel's out, m and l, one launch,
    a repeat bitwise equal; rows of up to ~60 edges, longer than the
    ring."""
    plan, _ = _plan(H * D, e=6000)
    kv, q, gy = _hgt_case(card, H, D, dtype, plan, seed=H * D)
    out, m, l = kops.hgt_forward(kv, q, plan)
    before = kops.hgt_backward.launches
    dq, dkv = kops.hgt_backward(kv, q, out, gy, m, l, plan)
    torch.cuda.synchronize()
    assert kops.hgt_backward.launches == before + 1
    r_dq, r_dkv = kops.hgt_backward_reference(kv, q, out, gy, m, l, plan)
    _close(dq, r_dq, rtol)
    _close(dkv, r_dkv, rtol)
    empty = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    assert bool((dq[empty] == 0).all())
    again = kops.hgt_backward(kv, q, out, gy, m, l, plan)
    assert torch.equal(dq, again[0]) and torch.equal(dkv, again[1])


def test_graphsage_pool_session_on_card_matches_the_plain_path(card):
    rng = np.random.default_rng(21)
    n, e = 2000, 16000
    graph = Graph(x=rng.normal(size=(n, 48)).astype(np.float32),
                  edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    model = GraphSAGEModel(64, 7, num_layers=3, aggr="pool",
                           dtype=torch.bfloat16, in_channels=48)
    sess = InferenceSession(model, (graph.x, graph.edge_index),
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    before = kops.spmm_max_csr.launches
    got = sess(graph.x, graph.edge_index)
    torch.cuda.synchronize()
    assert kops.spmm_max_csr.launches == before + 3
    with torch.inference_mode():
        want = sess.model(torch.tensor(graph.x, device=card).bfloat16(),
                          torch.tensor(graph.edge_index, device=card))
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=3e-2 * scale)


def test_hgt_model_on_card_takes_the_routes_of_the_plans(card):
    """bf16 eval on window plans: the fused kernels (6 forwards, 2 layers x
    3 relations); f32 training with dropout: the decomposed route, against
    the COO route under one generator state."""
    hg, target = synthetic_hetero()
    x_dict = {nt: torch.tensor(x, device=card) for nt, x in hg.x_dict.items()}
    ei = {et: torch.tensor(v, device=card)
          for et, v in hg.edge_index_dict.items()}
    torch.manual_seed(0)
    model = HGTModel(hg.metadata(), 128, 3, target, heads=2,
                     in_channels=32).to(card)
    plans = hg.csr_plans()
    with compute_dtype(torch.bfloat16), torch.no_grad():
        model.eval()
        before = kops.hgt_forward.launches
        got = model(x_dict, ei, plan_dict=plans)
        torch.cuda.synchronize()
        assert kops.hgt_forward.launches == before + 6
        want = model(x_dict, ei)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=3e-2 * float(want.abs().max()))
    model.train()
    y = torch.tensor(hg[target].y, device=card)
    results = []
    for p in (plans, None):
        model.zero_grad()
        gen = torch.Generator(device=card).manual_seed(3)
        out = model(x_dict, ei, plan_dict=p, generator=gen)
        torch.nn.functional.cross_entropy(out, y).backward()
        results.append((out.detach(), [q.grad.clone() for q in
                                       model.parameters()
                                       if q.grad is not None]))
    (out_k, g_k), (out_p, g_p) = results
    _close(out_k, out_p, 1e-4)
    scale = max(float(w.abs().max()) for w in g_p)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(float(b.abs().max()),
                                                   0.05 * scale))


def _bp_case(seed, n_dst, n_src, e, R):
    """Edges near the diagonal, every third destination block empty."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_dst, e)
    dst = dst[(dst // R) % 3 != 1]
    src = np.clip(dst * n_src // n_dst + rng.integers(-2 * R, 2 * R + 1,
                                                      dst.size),
                  0, n_src - 1)
    return src, dst


@pytest.mark.parametrize("F", [7, 40, 128, 256])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("weights", ["none", "given", "padded"])
@pytest.mark.parametrize("tiling", [(8, 8, 16), (256, 256, 256)])
def test_block_pair_kernel_matches_plain(card, F, dtype, rtol, weights,
                                         tiling):
    R, S, ET = tiling
    n_dst, n_src = 40 * R // 8 + 3, 50 * R // 8 + 5
    src, dst = _bp_case(F, n_dst, n_src, 30 * n_dst, R)
    plan = kops.build_block_pair_plan(src, dst, n_dst, num_src=n_src, R=R,
                                      S=S, ET=ET)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(n_src, F, generator=g).to(card, dtype)
    w = None
    if weights != "none":
        w = torch.rand(dst.size, generator=g).to(card)
    padded = weights == "padded"
    if padded:
        w = w[torch.from_numpy(plan.w_perm).long().to(card)]
    before = kops.spmm_block_pair.launches
    got = kops.spmm_block_pair(x, w, plan, weights_padded=padded)
    torch.cuda.synchronize()
    assert kops.spmm_block_pair.launches == before + 1
    assert got.dtype == dtype and got.shape == (n_dst, F)
    _close(got, kops.spmm_block_pair_reference(x, w, plan,
                                               weights_padded=padded), rtol)
    empty = (np.bincount(dst // R, minlength=plan.nblocks) == 0)
    assert empty.any()
    rows = torch.from_numpy(np.repeat(empty, R)[:n_dst]).to(card)
    assert bool((got[rows] == 0).all())
    # deterministic: no atomics, a fixed order in every row
    assert torch.equal(got, kops.spmm_block_pair(x, w, plan,
                                                 weights_padded=padded))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_pair_no_edges_and_reordered_plan(card, dtype):
    none = np.zeros(0, np.int64)
    empty = kops.build_block_pair_plan(none, none, 33, num_src=5, R=8, S=8,
                                       ET=16)
    out = kops.spmm_block_pair(torch.ones(5, 40, device=card, dtype=dtype),
                               torch.zeros(0, device=card), empty)
    torch.cuda.synchronize()
    assert out.shape == (33, 40) and bool((out == 0).all())
    rng = np.random.default_rng(5)
    n = 300
    dst = rng.integers(0, n, 3000)
    src = np.clip(dst + rng.integers(-6, 7, 3000), 0, n - 1)
    p = rng.permutation(n)
    plan = kops.build_block_pair_plan(p[src], p[dst], n, R=8, S=8, ET=16,
                                      reorder=True)
    x = torch.randn(n, 64).to(card, dtype)
    w = torch.rand(3000, device=card)
    perm = torch.from_numpy(plan.perm_nodes).to(card).long()
    got = torch.empty_like(x).index_copy_(
        0, perm, kops.spmm_block_pair(x[perm], w, plan))
    want = kops.spmm_csr_reference(x, w, kops.build_csr_plan(p[src], p[dst],
                                                             n))
    _close(got, want, 1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("F", [7, 256])
def test_block_pair_backward_matches_plain(card, dtype, rtol, F):
    """dx through the forward kernel on the transpose plan, dw through the
    dw kernel: 1 forward, 1 dx and 1 dw launch."""
    src, dst = _bp_case(7, 290, 330, 6000, 32)
    plan = kops.build_block_pair_plan(src, dst, 290, num_src=330, R=32,
                                      S=32, ET=64)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(333, F, generator=g).to(card, dtype).requires_grad_()
    w = torch.rand(dst.size, generator=g).to(card).requires_grad_()
    gy = torch.randn(290, F, generator=g).to(card, dtype)
    before = (kops.spmm_block_pair.launches, kops.block_pair_dw.launches)
    kops.spmm_block_pair(x, w, plan).backward(gy)
    torch.cuda.synchronize()
    assert (kops.spmm_block_pair.launches - before[0],
            kops.block_pair_dw.launches - before[1]) == (2, 1)
    xc, wc = x.detach().cpu().requires_grad_(), w.detach().cpu()
    wc.requires_grad_()
    kops.spmm_block_pair(xc, wc, plan).backward(gy.cpu())
    _close(x.grad, xc.grad, rtol)
    assert bool((x.grad[330:] == 0).all())
    _close(w.grad, wc.grad, 1e-5)
    _close(kops.block_pair_dw(x.detach(), gy, plan),
           kops.block_pair_dw_reference(x.detach(), gy, plan), 1e-5)


@pytest.mark.parametrize("F", [7, 40, 128, 256])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_block_pair_many_and_long_pairs(card, F, dtype, rtol):
    """A destination block whose sources lie in 40 source blocks, not
    contiguous (as a clustered order leaves them), and a pair of 20,000
    edges, several of the kernel's edge steps on one slab: the plain
    version's values, the same bits on a second run, and dx on the
    transpose plan."""
    rng = np.random.default_rng(F)
    n = 256 * 60
    spread = rng.choice(60, 40, replace=False)
    src = np.concatenate([spread[rng.integers(0, 40, 6000)] * 256
                          + rng.integers(0, 256, 6000),
                          256 * 5 + rng.integers(0, 256, 20000),
                          rng.integers(0, n, 3000)])
    dst = np.concatenate([rng.integers(0, 256, 6000),
                          256 * 7 + rng.integers(0, 256, 20000),
                          rng.integers(0, n, 3000)])
    plan = kops.build_block_pair_plan(src, dst, n)
    assert plan.block_ptr[1] - plan.block_ptr[0] >= 40
    g = torch.Generator().manual_seed(F)
    x = torch.randn(n, F, generator=g).to(card, dtype)
    w = torch.rand(src.size, generator=g).to(card)
    got = kops.spmm_block_pair(x, w, plan)
    _close(got, kops.spmm_block_pair_reference(x, w, plan), rtol)
    assert torch.equal(got, kops.spmm_block_pair(x, w, plan))
    tp = plan.transpose()
    dx = kops.spmm_block_pair(got, w, tp)
    _close(dx, kops.spmm_block_pair_reference(got, w, tp), rtol)
    assert torch.equal(dx, kops.spmm_block_pair(got, w, tp))


def test_hybrid_plan_on_card_runs_both_kernels(card):
    rng = np.random.default_rng(9)
    n = 2048
    sd, dd = [], []
    for b in range(n // 256):
        sd.append(b * 256 + rng.integers(0, 256, 600))
        dd.append(b * 256 + rng.integers(0, 256, 600))
    sd.append(rng.integers(0, n, 2000))
    dd.append(rng.integers(0, n, 2000))
    src, dst = np.concatenate(sd), np.concatenate(dd)
    plan = kops.build_hybrid_plan(src, dst, n)
    assert plan.bp is not None and plan.csr is not None
    x = torch.randn(n, 40, device=card)
    w = torch.rand(src.size, device=card)
    before = (kops.spmm_block_pair.launches, kops.spmm_csr.launches)
    got = kops.spmm_hybrid(x, w, plan)
    torch.cuda.synchronize()
    assert (kops.spmm_block_pair.launches - before[0],
            kops.spmm_csr.launches - before[1]) == (1, 1)
    _close(got, kops.spmm_csr_reference(x, w, kops.build_csr_plan(src, dst,
                                                                  n)), 1e-5)


def test_gcn_session_on_card_takes_the_block_pair_route(card):
    rng = np.random.default_rng(12)
    n, e = 4000, 40000
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-64, 65, e), 0, n - 1)
    p = rng.permutation(n)
    graph = Graph(x=rng.normal(size=(n, 48)).astype(np.float32),
                  edge_index=np.stack([p[src], p[dst]])).add_self_loop()
    g2, _ = graph.reorder_rcm()
    plan = g2.auto_plan()
    assert isinstance(plan, kops.BlockPairPlan), plan
    model = GCNModel(hidden_dim=64, num_class=7, num_layers=3,
                     dtype=torch.bfloat16)
    cpu = InferenceSession(model, (g2.x, g2.edge_index), device="cpu",
                           compute_dtype=torch.bfloat16, plan=plan)
    want = cpu(g2.x, g2.edge_index)
    gpu = InferenceSession(model, (g2.x, g2.edge_index), device="cuda",
                           compute_dtype=torch.bfloat16, plan=plan)
    before = (kops.spmm_block_pair.launches, kops.spmm_csr.launches)
    got = gpu(g2.x, g2.edge_index)
    torch.cuda.synchronize()
    assert (kops.spmm_block_pair.launches - before[0],
            kops.spmm_csr.launches - before[1]) == (3, 0)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=3e-2 * float(want.abs().max()))


@pytest.mark.parametrize("F", [1, 7, 40, 128, 256, 300])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("mode", ["none", "separate", "in place"])
def test_spmm_csr_acc_kernel_matches_plain(card, F, dtype, rtol, mode):
    plan, e = _plan(F + 11)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(plan.num_src, F, generator=g).to(card, dtype)
    w = torch.rand(e, generator=g).to(card)
    prev = torch.randn(plan.num_nodes, F, generator=g).to(card, dtype)
    p = None if mode == "none" else prev.clone()
    counter = kops.spmm_csr if p is None else kops.spmm_csr_acc
    before = counter.launches
    got = kops.spmm_csr_acc(x, w, plan, prev=p,
                            out=p if mode == "in place" else None)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if mode == "in place":
        assert got.data_ptr() == p.data_ptr()
    want = kops.spmm_csr_acc_reference(x, w, plan,
                                       prev=None if p is None else prev)
    _close(got, want, rtol)
    if p is not None:  # rows without edges keep prev bit for bit
        bare = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
        assert torch.equal(got[bare], prev[bare])
        assert torch.equal(got, kops.spmm_csr_acc(x, w, plan, prev=prev))


def _hub_plan(seed=0, n_dst=300, n_src=420, star=20_000, e=4000):
    """A star of ``star`` edges into row 0 (cut into work items at
    ROW_SPLIT) plus random edges; odd rows and the tail: empty."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          2 * rng.integers(0, n_dst // 3, e)])
    src = rng.integers(0, n_src, dst.shape[0])
    return kops.build_csr_plan(src, dst, n_dst, num_src=n_src)


@pytest.mark.parametrize("F", [7, 40, 64, 128, 256])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("op", ["spmm", "acc", "acc in place",
                                "segment_sum"])
def test_hub_rows_are_cut_and_folded(card, F, dtype, rtol, op):
    """A row of 20,000 edges: its items' partials folded by the second
    kernel; one launch and one fold a call; the result bitwise equal to the
    plain version (integer inputs and weights in eighths: every f32
    partial sum is exact), repeats too, rows without edges prev (or 0) bit
    for bit."""
    plan = _hub_plan(F)
    assert plan.row_split().cut_row.tolist() == [0]
    g = torch.Generator().manual_seed(F)
    E = plan.num_edges

    def ints(*shape):  # every f32 partial sum exact: any order, same bits
        return torch.randint(-4, 5, shape, generator=g).to(card, dtype)

    w = (torch.randint(0, 9, (E,), generator=g) / 8).to(card)
    prev = ints(plan.num_nodes, F)
    if op == "segment_sum":
        v = ints(E, F)
        counter, want = kops.segment_sum_csr, kops.segment_sum_csr_reference(
            v, plan, w)

        def run():
            return kops.segment_sum_csr(v, plan, w)
    else:
        x = ints(plan.num_src, F)
        acc = op != "spmm"
        counter = kops.spmm_csr_acc if acc else kops.spmm_csr
        want = kops.spmm_csr_acc_reference(x, w, plan,
                                           prev=prev if acc else None)

        def run():
            if op == "acc in place":
                out = prev.clone()
                got = kops.spmm_csr_acc(x, w, plan, prev=out, out=out)
                assert got.data_ptr() == out.data_ptr()
                return got
            return kops.spmm_csr_acc(x, w, plan, prev=prev if acc else None)
    before = (counter.launches, kops.csr_fold.launches)
    got = run()
    torch.cuda.synchronize()
    assert (counter.launches - before[0],
            kops.csr_fold.launches - before[1]) == (1, 1)
    _close(got, want, rtol)
    assert torch.equal(got, want)
    assert torch.equal(got, run())
    bare = torch.from_numpy(np.diff(plan.rowptr) == 0).to(card)
    keep = prev[bare] if op.startswith("acc") else torch.zeros_like(
        got[bare])
    assert torch.equal(got[bare], keep)


def test_fold_runs_exactly_when_a_plan_has_cut_rows(card):
    g = torch.Generator().manual_seed(0)
    for plan, cut in ((_plan(3)[0], False), (_hub_plan(3), True)):
        assert bool(plan.row_split().cut_row.size) == cut
        x = torch.randn(plan.num_src, 32, generator=g).to(card)
        v = torch.randn(plan.num_edges, 32, generator=g).to(card)
        prev = torch.randn(plan.num_nodes, 32, generator=g).to(card)
        before = kops.csr_fold.launches
        kops.spmm_csr(x, None, plan)
        kops.spmm_csr_acc(x, None, plan, prev=prev)
        kops.segment_sum_csr(v, plan)
        torch.cuda.synchronize()
        assert kops.csr_fold.launches - before == (3 if cut else 0)


def _max_counts():
    return (kops.segment_max_fold.launches, kops.segment_max_count.launches,
            kops.segment_max_count_fold.launches,
            kops.segment_max_bwd.launches)


@pytest.mark.parametrize("F", [7, 40, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_max_hub_rows_are_cut_and_folded(card, F, dtype, weighted):
    """The star of 20,000 edges is cut into items: the forward (max and
    min, gathered and per edge) is one launch and one fold, the backward
    one count, one count fold and one launch; every result bitwise equal
    to the plain version (dw within 1e-5), repeats too. Integer features
    tie across items; the star's first item holds only -inf in column 0
    of the per-edge rows, and its every message is -inf in column 1."""
    plan = _hub_plan(F + 1)
    assert plan.row_split().cut_row.tolist() == [0]
    g = torch.Generator().manual_seed(F)
    x = torch.randint(-3, 4, (plan.num_src, F), generator=g).to(card, dtype)
    w = (torch.randint(1, 5, (plan.num_edges,), generator=g) / 4).to(card)
    w = w if weighted else None
    for fn, ref in ((kops.spmm_max_csr, kops.spmm_max_csr_reference),
                    (kops.spmm_min_csr, kops.spmm_min_csr_reference)):
        before = (fn.launches, kops.segment_max_fold.launches)
        got = fn(x, w, plan)
        torch.cuda.synchronize()
        assert (fn.launches - before[0],
                kops.segment_max_fold.launches - before[1]) == (1, 1)
        assert torch.equal(got, ref(x, w, plan))
        assert torch.equal(got, fn(x, w, plan))
    msg = x[plan.arrays(card)[1].long()]
    star = int(plan.rowptr[1])
    msg[:kops.ROW_SPLIT, 0] = -np.inf
    if F > 1:
        msg[:star, 1] = -np.inf
    for fn, ref in ((kops.segment_max_csr, kops.segment_max_csr_reference),
                    (kops.segment_min_csr, kops.segment_min_csr_reference)):
        before = (fn.launches, kops.segment_max_fold.launches)
        got = fn(msg, plan)
        torch.cuda.synchronize()
        assert (fn.launches - before[0],
                kops.segment_max_fold.launches - before[1]) == (1, 1)
        assert torch.equal(got, ref(msg, plan))
    wp = None if w is None else kops.pad_edge_weights(plan, w)
    for xin, wi, per_edge in ((x, wp, False), (msg, None, True)):
        out = (kops.segment_max_csr(xin, plan) if per_edge
               else kops.spmm_max_csr(xin, wi, plan, weights_padded=True))
        gy = torch.randn(out.shape, generator=g).to(card, dtype)
        before = _max_counts()
        dmsg, dw = kops.segment_max_bwd(xin, wi, out, gy, plan, per_edge,
                                        True)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_max_counts(), before)) == (
            0, 1, 1, 1)
        rdmsg, rdw = kops.segment_max_bwd_reference(
            xin, wi, out, gy, plan, per_edge, wi is not None)
        assert torch.equal(dmsg, rdmsg)
        assert torch.equal(dmsg, kops.segment_max_bwd(
            xin, wi, out, gy, plan, per_edge, True)[0])
        if wi is not None:
            _close(dw, rdw, 1e-5)


def test_segment_max_folds_run_exactly_when_a_plan_has_cut_rows(card):
    g = torch.Generator().manual_seed(1)
    for plan, cut in ((_plan(5)[0], False), (_hub_plan(5), True)):
        assert bool(plan.row_split().cut_row.size) == cut
        x = torch.randn(plan.num_src, 32, generator=g).to(card)
        before = _max_counts()
        out = kops.spmm_max_csr(x, None, plan)
        kops.segment_max_bwd(x, None, out, torch.ones_like(out), plan,
                             False, False)
        torch.cuda.synchronize()
        want = (1, 1, 1, 1) if cut else (0, 0, 0, 1)
        assert tuple(a - b for a, b in zip(_max_counts(), before)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_csr_acc_no_edges_and_row_slice(card, dtype):
    none = np.zeros(0, np.int64)
    empty = kops.build_csr_plan(none, none, 33, num_src=5)
    prev = torch.randn(33, 40, device=card).to(dtype)
    out = kops.spmm_csr_acc(torch.ones(5, 40, device=card, dtype=dtype),
                            torch.zeros(0, device=card), empty, prev=prev)
    torch.cuda.synchronize()
    assert torch.equal(out, prev)
    plan, e = _plan(3)
    table = torch.randn(3 * plan.num_src, 64, device=card).to(dtype)
    x = table[plan.num_src:2 * plan.num_src]  # a pointer offset
    w = torch.rand(e, device=card)
    prev = torch.randn(plan.num_nodes, 64, device=card).to(dtype)
    _close(kops.spmm_csr_acc(x, w, plan, prev=prev),
           kops.spmm_csr_acc_reference(x, w, plan, prev=prev),
           1e-2 if dtype == torch.bfloat16 else 1e-5)
    with pytest.raises(TypeError, match="dtype"):
        kops.spmm_csr_acc(x.half(), w, plan, prev=prev.half())


def test_planned_tier_on_card_matches_the_cpu(card):
    from gammagl_tpu_torch import parallel as tpar
    rng = np.random.default_rng(5)
    n, e = 3000, 40000
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 96)).astype(np.float32)
    part = tpar.build_halo_partition_planned(ei, n, 1, w, num_src_blocks=4)
    assert len(part.interior) >= 4
    outs, grads = [], []
    for dev in (card, torch.device("cpu")):
        xt = tpar.shard_nodes(x, part, device=dev).requires_grad_()
        before = (kops.spmm_csr.launches, kops.spmm_csr_acc.launches)
        out = tpar.make_halo_spmm_planned(part)(xt)
        (out ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            acc = (len(part.interior) - 1
                   + len(part.transpose.interior) - 1)
            assert (kops.spmm_csr.launches - before[0],
                    kops.spmm_csr_acc.launches - before[1]) == (2, acc)
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    _close(outs[0], outs[1], 1e-5)
    _close(grads[0], grads[1], 1e-5)


def test_staged_gcn_on_card_matches_the_cpu(card):
    from gammagl_tpu_torch import parallel as tpar
    rng = np.random.default_rng(6)
    n, e, f, c = 2000, 30000, 32, 5
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = np.concatenate([ei, np.tile(np.arange(n), (2, 1))], 1)
    from gammagl_tpu_torch.utils import calc_gcn_norm_np
    part = tpar.build_halo_partition_planned(ei, n, 1, calc_gcn_norm_np(
        ei, n), num_src_blocks=3)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    m = (rng.random(n) < 0.3).astype(np.float32)
    losses = []
    for dev in (card, torch.device("cpu")):
        params, opt, step, ev = tpar.make_partitioned_gcn_train_staged(
            part, f, 32, c, num_layers=3, compute_dtype=torch.float32,
            device=dev)
        xs, ys, ms = (tpar.shard_nodes(a, part, device=dev)
                      for a in (x, y, m))
        run = []
        for _ in range(3):
            params, opt, loss = step(params, opt, xs, ys, ms)
            run.append(float(loss))
        losses.append(run)
        assert ev(params, xs).shape == (part.rows_per, c)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_max_infinite_winner_gives_zero(card, dtype):
    plan, e = _plan(7)
    x = torch.randn(plan.num_src, 16, device=card).to(dtype)
    x[:, 0], x[:, 1] = -float("inf"), float("inf")
    got = kops.spmm_max_csr(x, None, plan)
    assert torch.equal(got, kops.spmm_max_csr_reference(x, None, plan))
    assert bool((got[:, 0] == 0).all()) and bool(torch.isinf(got[:, 1]).any())
    got = kops.spmm_min_csr(x, None, plan)
    assert torch.equal(got, kops.spmm_min_csr_reference(x, None, plan))
    assert bool((got[:, 1] == 0).all())


def test_hgt_flash_packed_create_graph_raises_on_card(card):
    plan, _ = _plan(8)
    g = torch.Generator().manual_seed(8)
    kv = torch.randn(plan.num_src, 2 * 2 * 8, generator=g).to(card)
    kv.requires_grad_()
    q = torch.randn(plan.num_nodes, 2, 8, generator=g).to(card)
    loss = kops.hgt_flash_packed(kv, q, plan).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, kv, create_graph=True)


def _launch_counts():
    return {"spmm": kops.spmm_csr.launches,
            "segsum": kops.segment_sum_csr.launches,
            "expand": kops.expand_dst_csr.launches,
            "sddmm": kops.sddmm_csr.launches,
            "max": kops.segment_max_csr.launches,
            "flash": kops.flash_forward.launches}


def _launched(before):
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


@pytest.mark.parametrize("H", [1, 8])
def test_segment_softmax_padded_on_card_matches_plain(card, H):
    """Forward and gradient against the plain versions (the same call on
    CPU tensors): a row of -inf scores gives 0, rows without edges stay
    out; the forward launches the segment max, two expands and the
    segment sum, its backward one segment sum and one expand."""
    plan, e = _plan(20)
    g = torch.Generator().manual_seed(20)
    s = torch.randn(e, H, generator=g) * 3
    s[torch.from_numpy(plan.perm[:plan.rowptr[3]])] = -float("inf")
    cot = torch.randn(e, H, generator=g)
    results = []
    for dev in (card, torch.device("cpu")):
        sd = s.to(dev).requires_grad_()
        before = _launch_counts()
        out = kops.segment_softmax_padded(sd, plan)
        (out * cot.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _launched(before) == {"max": 1, "expand": 3, "segsum": 2}
        results.append((out.detach().cpu(), sd.grad.cpu()))
    (out, ds), (want, want_ds) = results
    _close(out, want, 1e-5)
    _close(ds, want_ds, 1e-5)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("H,F", [(1, 40), (8, 64), (3, 7)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_bspmm_csr_on_card_matches_plain(card, H, F, dtype, rtol):
    """Forward and both gradients against the plain versions: H SpMM
    launches forward, H more (dx on the transpose plan) and H SDDMM
    (dalpha) backward."""
    plan, e = _plan(21)
    g = torch.Generator().manual_seed(21)
    x = torch.randn(plan.num_src, H, F, generator=g).to(dtype)
    a = torch.rand(e, H, generator=g)
    cot = torch.randn(plan.num_nodes, H, F, generator=g)
    results = []
    for dev in (card, torch.device("cpu")):
        xd, ad = x.to(dev).requires_grad_(), a.to(dev).requires_grad_()
        before = _launch_counts()
        out = kops.bspmm_csr(xd, ad, plan)
        (out.float() * cot.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _launched(before) == {"spmm": 2 * H, "sddmm": H}
        results.append((out.detach().cpu(), xd.grad.cpu(), ad.grad.cpu()))
    for got, want in zip(*results):
        _close(got, want, rtol)


def test_han_cross_type_plan_route_on_card_matches_plain(card):
    """HANConv on the synthetic typed graph (two relations between node
    types, one within a type), each relation's plan on the card, against
    the plain COO route: one flash forward a relation, and on movie ->
    director (200 source rows, 60 destinations) the destination scores of
    source rows min(d, 199), read in bounds."""
    from gammagl_tpu_torch.layers.conv import HANConv
    hg, _ = synthetic_hetero()
    torch.manual_seed(22)
    conv = HANConv(32, 4, hg.metadata(), heads=2).to(card).eval()
    x = {nt: torch.from_numpy(v).to(card) for nt, v in hg.x_dict.items()}
    ei = {et: torch.from_numpy(v).to(card)
          for et, v in hg.edge_index_dict.items()}
    before = _launch_counts()
    got = conv(x, ei, plan_dict=hg.csr_plans())
    torch.cuda.synchronize()
    assert _launched(before) == {"flash": 3}
    want = conv(x, ei)
    for nt in want:
        _close(got[nt], want[nt], 1e-5)


@pytest.mark.parametrize("name", ["rgcn", "simplehgn"])
def test_typed_edge_models_on_card_match_the_plain_path(card, name):
    """RGCNModel and SimpleHGNModel with the edges' plan on the card
    against the plain COO path: eval logits and the gradients of a loss,
    float32."""
    from gammagl_tpu_torch.examples import rgcn_trainer, simplehgn_trainer
    from gammagl_tpu_torch.models import RGCNModel, SimpleHGNModel
    torch.manual_seed(23)
    if name == "rgcn":
        d = rgcn_trainer.synthetic_kg()
        n = d["num_nodes"]
        x = torch.randn(n, 16)
        model = RGCNModel(16, 8, 4, d["num_relations"])
    else:
        d = simplehgn_trainer.typed_graph()
        x, n = torch.from_numpy(d["x"]), d["x"].shape[0]
        model = SimpleHGNModel(d["num_relations"], 8, 3, heads=2,
                               in_channels=32)
    ei = torch.from_numpy(d["edge_index"]).to(card)
    et = torch.from_numpy(d["edge_type"]).to(card)
    plan = kops.build_csr_plan(d["edge_index"][0], d["edge_index"][1], n)
    model = model.to(card).eval()
    outs = []
    for p in (plan, None):
        model.zero_grad()
        out = model(x.to(card), ei, et, plan=p)
        out.square().mean().backward()
        outs.append((out.detach(), [q.grad.clone() for q in
                                    model.parameters()]))
    (got, gg), (want, wg) = outs
    _close(got, want, 1e-5)
    for a, b in zip(gg, wg):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


ZOO = {"sgc": ("SGCModel", {"num_class": 4}),
       "appnp": ("APPNPModel", {"hidden_dim": 16, "num_class": 4}),
       "gcnii": ("GCNIIModel", {"hidden_dim": 16, "num_class": 4,
                                "num_layers": 4}),
       "gcnii_variant": ("GCNIIModel", {"hidden_dim": 16, "num_class": 4,
                                        "num_layers": 4, "variant": True}),
       "jknet": ("JKNet", {"num_class": 4}),
       "chebnet": ("ChebNetModel", {"num_class": 4}),
       "mixhop": ("MixHopModel", {"num_class": 4}),
       "gprgnn": ("GPRGNNModel", {"hidden_dim": 16, "num_class": 4}),
       "fagcn": ("FAGCNModel", {"num_class": 4})}


@pytest.mark.parametrize("name", sorted(ZOO) + ["agnn"])
def test_zoo_plan_route_on_card_matches_plain(card, name):
    """Each model of the propagation zoo (and the agnn twin's network)
    with the graph's plan on the card against its plain COO path: eval
    logits, the gradients of a loss in training mode under one generator
    state, and the launches (one `spmm_csr` a hop forward and one a hop
    whose input carries a gradient backward; the SDDMM for AGNN's and
    FAGCN's attention), float32."""
    from gammagl_tpu_torch import models
    from gammagl_tpu_torch.examples import agnn_trainer
    torch.manual_seed(31)
    rng = np.random.default_rng(31)
    n = 3000
    ei = np.stack([rng.integers(0, n, 24000), rng.integers(0, n - 50,
                                                           24000)])
    ei = np.concatenate([ei, np.stack([np.arange(n)] * 2)], 1)
    x = torch.randn(n, 24).to(card)
    tei = torch.from_numpy(ei).to(card)
    plan = kops.build_csr_plan(ei[0], ei[1], n)
    if name == "agnn":
        model = agnn_trainer.Net(16, 4, in_channels=24).to(card)

        def forward(p, **kw):
            return model.run(x, tei, plan=p, **kw)
    else:
        cls, kw = ZOO[name]
        model = getattr(models, cls)(in_channels=24, **kw).to(card)

        def forward(p, **kw):
            return model(x, tei, plan=p, **kw)
    outs = []
    for p in (plan, None):
        model.eval()
        with torch.no_grad():
            before = kops.spmm_csr.launches
            logits = forward(p)
            torch.cuda.synchronize()
            assert (kops.spmm_csr.launches > before) == (p is not None)
        model.train().zero_grad()
        gen = ({"generator": torch.Generator(card).manual_seed(32)}
               if name == "agnn" or "generator" in inspect.signature(
                   model.forward).parameters else {})
        out = forward(p, **gen)
        before = kops.sddmm_csr.launches
        out.square().mean().backward()
        torch.cuda.synchronize()
        dw = kops.sddmm_csr.launches - before
        assert dw == (2 if p is not None and name in ("agnn", "fagcn")
                      else 0)
        outs.append((logits, [q.grad.clone() for q in model.parameters()]))
    (got, gg), (want, wg) = outs
    _close(got, want, 1e-5)
    for a, b in zip(gg, wg):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _wave2_case(name, n=60, e=300, f=6):
    """(conv, inputs after x and edge_index, keyword arguments) of a
    wave-2 conv on a random graph of ``n`` nodes whose last rows receive
    no edge."""
    from gammagl_tpu_torch.layers import conv as C
    g = torch.Generator().manual_seed(30)
    ei = torch.stack([torch.randint(0, n, (e,), generator=g),
                      torch.randint(0, n - 8, (e,), generator=g)])
    torch.manual_seed(31)
    extra, kw = (), {}
    if name == "pna":
        conv = C.PNAConv(f, 5)
    elif name == "film":
        conv = C.FILMConv(f, 5, num_relations=3)
        extra = (torch.randint(0, 3, (e,), generator=g),)
    elif name == "edge":
        conv = C.EdgeConv(f, 5)
    elif name == "gmm":
        conv = C.GMMConv(f, 5)
        extra = (torch.rand(e, 2, generator=g),)
    elif name == "comp":
        conv = C.CompConv(f, 5)
        extra = (torch.randint(0, 3, (e,), generator=g),
                 torch.randn(3, f, generator=g))
    elif name == "gaan":
        conv = C.GaANConv(f, 5, heads=3)
    elif name == "dna":
        conv = C.DNAConv(f, heads=2)
    else:
        conv = C.HypergraphConv(f, 5)
        kw = {"num_edges": n}
    x = torch.randn((n, 3, f) if name == "dna" else (n, f), generator=g)
    return conv, x, ei, extra, kw


@pytest.mark.parametrize("name", ["pna", "film", "edge", "gmm", "comp",
                                  "gaan", "dna", "hcha"])
def test_wave2_conv_on_card_matches_the_cpu(card, name):
    """Each wave-2 conv (COO on every device, as in JAX) on the card
    against the same module on the CPU: output and the gradients of a
    loss in every parameter and in x, float32; no kernel launches."""
    conv, x, ei, extra, kw = _wave2_case(name)
    results = []
    for dev in ("cpu", card):
        m = copy.deepcopy(conv).to(dev)
        tx = x.clone().to(dev).requires_grad_()
        before = _launch_counts()
        out = m(tx, ei.to(dev), *(a.to(dev) for a in extra), **kw)
        out = out[0] if isinstance(out, tuple) else out
        out.square().mean().backward()
        torch.cuda.synchronize()
        assert _launched(before) == {}
        # CompConv's relation map does not reach this loss: no gradient
        results.append((out.detach().cpu(), [tx.grad.cpu()] + [
            None if p.grad is None else p.grad.cpu()
            for p in m.parameters()]))
    (want, wg), (got, gg) = results
    _close(got, want, 1e-5)
    for a, b in zip(gg, wg):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


def _write_imdb(root, sizes=(40, 15, 55), f=12, c=3):
    """IMDB's processed layout at a small size, more actors than movies
    (as in the release): each movie one director and three actors."""
    import os
    import scipy.sparse as sp
    rng = np.random.default_rng(32)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    n_m, n_d, n_a = sizes
    y = rng.integers(0, c, n_m)
    for i, n in enumerate(sizes):
        x = (rng.random((n, f)) < 0.3).astype(np.float32)
        if i == 0:
            x[np.arange(n_m), y] = 1.0
        sp.save_npz(os.path.join(raw, f"features_{i}.npz"), sp.csr_matrix(x))
    np.save(os.path.join(raw, "labels.npy"), y)
    perm = rng.permutation(n_m)
    np.savez(os.path.join(raw, "train_val_test_idx.npz"),
             train_idx=perm[:20], val_idx=perm[20:25], test_idx=perm[25:])
    offs = np.concatenate([[0], np.cumsum(sizes)])
    adj = np.zeros((offs[-1], offs[-1]), np.float32)
    for m in range(n_m):
        d = n_m + rng.integers(0, n_d)
        for a in offs[2] + rng.choice(n_a, 3, replace=False):
            adj[m, a] = adj[a, m] = 1
        adj[m, d] = adj[d, m] = 1
    sp.save_npz(os.path.join(raw, "adjM.npz"), sp.csr_matrix(adj))


def test_han_twin_on_imdb_files_plan_route_matches_coo(card, tmp_path):
    """The han twin reads a fabricated IMDB (actor -> movie has more
    source rows than destination rows, ROADMAP C14) and trains 2 steps on
    the card, each relation's GAT on its plan: one flash forward a
    relation a forward, a flash backward and two SpMM for each relation
    into movies a step; then its model's plan route against its COO
    route, float32 1e-5 and bf16 3e-2 of max |logit|."""
    from gammagl_tpu_torch.examples import common, han_trainer
    _write_imdb(str(tmp_path))
    args = han_trainer.parser().parse_args(
        ["--dataset_path", str(tmp_path), "--n_epoch", "2"])
    hg, target = han_trainer.load(args)
    assert hg["actor"].num_nodes > hg["movie"].num_nodes
    before = _launch_counts()
    out = han_trainer.main(args)
    torch.cuda.synchronize()
    # flash forwards: 2 steps and 3 evaluations of 4 relations; two SpMM
    # (the score's and the features' gradients, ROADMAP C39) for each of
    # the 2 relations into movies a step
    assert _launched(before) == {"flash": 2 * 4 + 3 * 4, "spmm": 2 * 2 * 2}
    assert np.isfinite(out["losses"]).all()
    x_dict, ei_dict, _, _, _ = common.hetero_tensors(hg, target, card)
    model = out["state"].model
    for dtype, tol in ((None, 1e-5), (torch.bfloat16, 3e-2)):
        with compute_dtype(dtype):
            got = common.predict(model, x_dict, ei_dict,
                                 plan_dict=hg.csr_plans())
            want = common.predict(model, x_dict, ei_dict)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * float(want.abs().max()))


def _sampled_graph(n=400, e=3000, f=24, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 30, e)])
    return Graph(x=rng.normal(size=(n, f)).astype(np.float32),
                 edge_index=ei, y=rng.integers(0, 5, n),
                 train_mask=rng.random(n) < 0.6)


def test_sampled_sage_on_card_matches_the_cpu(card):
    """GraphSAGESampleModel on a bucket-padded sampled batch (padded
    destinations out of range): the card's forward and every gradient
    against the same module on the CPU, f32."""
    from gammagl_tpu_torch.examples.sage_sample_trainer import pad_batch_ids
    from gammagl_tpu_torch.loader import NeighborSamplerLoader
    from gammagl_tpu_torch.models import GraphSAGESampleModel
    g = _sampled_graph()
    loader = NeighborSamplerLoader(g.edge_index, sample_lists=[6, 3],
                                   num_nodes=g.num_nodes, seed=1)
    n_id_p, eis, sizes = pad_batch_ids(*loader.sample(np.arange(32)))
    torch.manual_seed(0)
    cpu = GraphSAGESampleModel(32, 5, drop_rate=0.0, in_channels=24)
    gpu = copy.deepcopy(cpu).to(card)
    outs = []
    for model, dev in ((cpu, torch.device("cpu")), (gpu, card)):
        x = torch.from_numpy(g.x[n_id_p]).to(dev).requires_grad_()
        out = model(x, [(torch.from_numpy(e).to(dev), s)
                        for e, s in zip(eis, sizes)])
        torch.nn.functional.cross_entropy(
            out, torch.from_numpy(g.y[n_id_p[:32]]).to(dev)).backward()
        outs.append((out, x.grad))
    _close(outs[1][0], outs[0][0], 1e-5)
    _close(outs[1][1], outs[0][1], 1e-4)
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(pc.grad.abs().max())
        assert float((pg.grad.cpu() - pc.grad).abs().max()) <= 1e-4 * scale, \
            name


@pytest.mark.parametrize("budget", [0, 150, 400])
def test_device_feature_cache_cold_rows_from_pinned_memory(card, budget):
    """Hot rows on the card, cold ones through a pinned buffer: every
    gather bitwise x[idx], hits and misses as the host counts them."""
    from gammagl_tpu_torch.loader import DeviceFeatureCache
    g = _sampled_graph()
    score = np.random.default_rng(2).random(g.num_nodes)
    cache = DeviceFeatureCache(g.x, budget_rows=budget, score=score)
    assert cache.device.type == "cuda" and cache.host.is_pinned()
    assert cache.hot.device.type == "cuda" and len(cache.hot) == budget
    rng = np.random.default_rng(3)
    hits = 0
    for _ in range(5):
        idx = rng.integers(0, g.num_nodes, 700)
        got = cache[idx]
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), g.x[idx])
        hits += int((cache.slot_of[idx] >= 0).sum())
    assert (cache.hits, cache.misses) == (hits, 5 * 700 - hits)


def test_prefetch_loader_on_a_side_stream_matches_sync_copies(card):
    """Batches moved by the prefetch thread on its stream, bitwise the
    same batches moved synchronously; the consumer's work on them sees the
    finished copies."""
    from gammagl_tpu_torch.loader import NodeNeighborLoader, PrefetchLoader
    g = _sampled_graph()
    batches = list(NodeNeighborLoader(g, [5, 3], batch_size=50, seed=4))
    want = [b.tensor(card) for b in batches]
    got = list(PrefetchLoader(batches, size=2))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert sorted(a.keys()) == sorted(b.keys())
        for k in b.keys():
            if isinstance(b[k], torch.Tensor):
                assert a[k].device.type == "cuda"
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
        assert torch.equal((a.x * 2).sum(0), (b.x * 2).sum(0))


def test_micro_batcher_calls_a_card_session_from_its_worker(card):
    """`run_fn` runs on the MicroBatcher's thread: an `InferenceSession`
    on the card called there gives each request its row of the batch's
    logits, as a call on this thread does."""
    import threading
    from gammagl_tpu_torch.serve import MicroBatcher
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 3))
    sess = InferenceSession(model, (torch.zeros(8, 6),), device=card)
    threads = set()

    def run(batch, n_valid):
        threads.add(threading.get_ident())
        return sess(batch)

    xs = np.random.default_rng(5).normal(size=(20, 6)).astype(np.float32)
    with MicroBatcher(run, buckets=(8,), linger_ms=5.0) as mb:
        outs = [f.result(timeout=60) for f in
                [mb.submit(x) for x in xs]]
    assert threading.get_ident() not in threads and len(threads) == 1
    want = sess(torch.from_numpy(xs)).cpu().numpy()
    for o, w in zip(outs, want):
        assert o.shape == (3,)
        np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6)


def _ssl_case(name):
    """A self-supervised / autoencoder / spectral model of the port at a
    small size, its inputs (the draws made on the CPU from a seed) and a
    loss of its output."""
    from gammagl_tpu_torch import models as M
    g = torch.Generator().manual_seed(35)
    n, f, h = 50, 12, 16
    x = torch.randn(n, f, generator=g)
    ei = torch.stack([torch.randint(0, n, (200,), generator=g),
                      torch.randint(0, n, (200,), generator=g)])
    ei = torch.cat([ei, torch.arange(n).repeat(2, 1)], 1)
    xc = M.corrupt_features(x, g)
    fm, em = (torch.rand((1, f), generator=g) < 0.8,
              torch.rand(ei.shape[1], generator=g) < 0.8)
    em[-n:] = True  # every node keeps its self-loop (ROADMAP C28)
    xa, wa = M.drop_edge_and_feature(x, ei, 0.2, 0.2, feat_mask=fm,
                                     edge_mask=em)
    torch.manual_seed(35)
    if name == "dgi":
        return M.DGIModel(h, f), (x, ei, xc), lambda o: o
    if name == "ggd":
        return M.GGDModel(h, f), (x, ei, xc), lambda o: o
    if name == "mvgrl":
        w = torch.rand(ei.shape[1], generator=g)
        return M.MVGRLModel(h, f), (x, ei, ei, w, xc), lambda o: o
    if name == "grace":
        return (M.GraceModel(h, h, in_channels=f), (xa, ei, wa, x, ei, None),
                lambda o: o)
    if name == "infograph":
        batch = torch.arange(n) * 5 // n
        return (M.InfoGraph(h, 2, f), (x, ei, batch, 5),
                lambda o: o[0] + o[1].square().mean())
    if name == "gae":
        return M.GAEModel(h, 8, f), (x, ei), lambda o: o.square().mean()
    if name == "vgae":
        noise = torch.randn(n, 8, generator=g)
        return (M.VGAEModel(h, 8, f), (x, ei, None, None, None, noise),
                lambda o: M.recon_loss(o[2], ei, ei.flip(0))
                + M.VGAEModel.kl_loss(o[0], o[1]) / n)
    if name == "specformer":
        lam, u = (torch.from_numpy(a) for a in M.laplacian_eigh(ei.numpy(),
                                                                 n))
        return (M.SpecformerModel(3, h, num_filters=2, drop_rate=0.0,
                                  in_channels=f), (x, lam, u),
                lambda o: o.square().mean())
    model = M.MGNNIModel(3, h, iters=8, in_channels=f)
    with torch.no_grad():  # singular values apart (ROADMAP C29)
        for w in model.ws:
            w.mul_(torch.linspace(0.6, 1.4, h))
    return model, (x, ei), lambda o: o.square().mean()


def _to(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return v


@pytest.mark.parametrize("name", ["dgi", "ggd", "mvgrl", "grace",
                                  "infograph", "gae", "vgae", "specformer",
                                  "mgnni"])
def test_ssl_model_on_card_matches_the_cpu(card, name):
    """Each model of `models/ssl.py`, `autoencoder.py` and `spectral.py`
    (COO on every device, as in JAX) on the card against the same module
    on the CPU from the same weights and draws: output and loss at 1e-5
    of max |out|, every parameter's gradient at 1e-4 of its max |grad|
    (Specformer's attention key bias, whose gradient is 0 by the math,
    at 1e-4 of the model's largest); no kernel launches. MGNNI's ``w_m``
    have their singular values apart (ROADMAP C29)."""
    model, inputs, loss_of = _ssl_case(name)
    results = []
    for dev in ("cpu", card):
        m = copy.deepcopy(model).to(dev)
        before = _launch_counts()
        out = m(*(_to(v, dev) for v in inputs))
        loss = loss_of(out)
        loss.backward()
        torch.cuda.synchronize()
        assert _launched(before) == {}
        leaves = out if isinstance(out, tuple) else (out,)
        results.append(([v.detach().cpu() for v in leaves], loss.detach(),
                        {k: None if p.grad is None else p.grad.cpu()
                         for k, p in m.named_parameters()}))
    (want, wl, wg), (got, gl, gg) = results
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    _close(gl.reshape(1), wl.reshape(1), 1e-5)
    largest = max(float(b.abs().max()) for b in wg.values() if b is not None)
    for k, b in wg.items():
        a = gg[k]
        assert (a is None) == (b is None)
        if b is not None:
            scale = largest if k == "attn.key.bias" else float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)


def test_ssl_draws_on_the_card(card):
    """The augmentations draw on the generator's device: a card generator
    gives card tensors, the same seed the same draw, a permutation."""
    from gammagl_tpu_torch.models import (corrupt_features,
                                          drop_edge_and_feature)
    x = torch.arange(3000.0, device=card).reshape(1000, 3)
    ei = torch.zeros(2, 5000, dtype=torch.long, device=card)
    outs = []
    for _ in range(2):
        g = torch.Generator(device=card).manual_seed(7)
        outs.append((corrupt_features(x, g),
                     *drop_edge_and_feature(x + 1, ei, 0.3, 0.5, g)))
    for a, b in zip(*outs):
        assert a.is_cuda and torch.equal(a, b)
    assert torch.equal(outs[0][0][:, 0].sort().values, x[:, 0])
    assert abs(float(outs[0][2].mean()) - 0.5) < 0.05


@pytest.mark.parametrize("name", ["dgi", "grace", "vgae"])
def test_ssl_twin_on_card_matches_the_cpu(card, name):
    """The twin's loop on the card against the same loop on the CPU, from
    the same init and the same draws (made on the CPU, handed to both):
    losses at rtol 1e-4."""
    from gammagl_tpu_torch.examples import (dgi_trainer, grace_trainer,
                                            vgae_trainer)
    from gammagl_tpu_torch.examples.common import synthetic_community_graph
    module = {"dgi": dgi_trainer, "grace": grace_trainer,
              "vgae": vgae_trainer}[name]
    data = synthetic_community_graph(num_nodes=80, num_classes=4,
                                     feat_dim=12, avg_degree=4, seed=3)
    n, e = 80, None
    g = torch.Generator().manual_seed(5)
    if name == "dgi":
        draws = [torch.randperm(n, generator=g) for _ in range(20)]
    elif name == "vgae":
        draws = [torch.randn(n, 16, generator=g) for _ in range(4)]
    else:
        e = data["edge_index"].shape[1] + n
        draws = [tuple((torch.rand((1, 12), generator=g) < 0.8,
                        torch.cat([torch.rand(e - n, generator=g) < 0.8,
                                   torch.ones(n, dtype=torch.bool)]))
                       for _ in range(2)) for _ in range(4)]
    losses = []
    for dev in ("cpu", "cuda"):
        args = module.parser().parse_args(["--device", dev, "--n_epoch",
                                           "4"])
        torch.manual_seed(0)
        out = module.main(args, data=data, draws=iter(draws))
        losses.append(out["losses"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


@pytest.mark.parametrize("per_edge", [0, 1])
@pytest.mark.parametrize("cut", [False, True])
def test_spmm_csr_op_passes_opcheck_on_the_card(card, per_edge, cut):
    """``gammagl::spmm_csr`` (the kernel behind `spmm_csr` and
    `segment_sum_csr`): schema, fake tensor and dispatch checks on CUDA
    tensors, bf16 with (E, 2) weights, on a plan with and without cut
    rows."""
    from gammagl_tpu_torch.ops.cuda.segment_matmul import _op_args
    plan, _ = _plan(7)
    if cut:
        src = np.concatenate([plan.col, np.arange(kops.ROW_SPLIT + 9) % 420])
        dst = np.concatenate([np.repeat(np.arange(plan.num_nodes),
                                        np.diff(plan.rowptr)),
                              np.full(kops.ROW_SPLIT + 9, 2)])
        plan = kops.build_csr_plan(src, dst, plan.num_nodes, num_src=420)
        assert plan.row_split().cut_row.shape[0] == 1
    g = torch.Generator().manual_seed(8)
    rows = plan.num_edges if per_edge else plan.num_src
    v = torch.randn(rows, 16, generator=g).to(card, torch.bfloat16)
    w = torch.rand(plan.num_edges, 2, generator=g).to(card)
    args = (v, w, *_op_args(plan, card), per_edge)
    torch.library.opcheck(torch.ops.gammagl.spmm_csr.default, args)


def test_exported_gcn_runs_the_kernel_from_a_file(card, tmp_path):
    """A planned 3-layer GCN exported on the card, saved and loaded gives
    the live session's logits bitwise, with 3 `spmm_csr` launches a
    request."""
    from gammagl_tpu_torch.serve import (export_forward, load_exported,
                                         save_exported)
    rng = np.random.default_rng(9)
    n, e = 3000, 24000
    x = rng.normal(size=(n, 48)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    model = GCNModel(hidden_dim=64, num_class=7, num_layers=3,
                     dtype=torch.bfloat16)
    plan = graph.csr_plan()
    sess = InferenceSession(model, (x, graph.edge_index), device="cuda",
                            compute_dtype=torch.bfloat16, plan=plan)
    want = sess(x, graph.edge_index)
    ep = export_forward(model, (x, graph.edge_index), device="cuda",
                        compute_dtype=torch.bfloat16, plan=plan)
    save_exported(ep, tmp_path / "gcn.pt2")
    prog = load_exported(tmp_path / "gcn.pt2")
    xt = torch.from_numpy(x).to(card)
    eit = torch.as_tensor(np.asarray(graph.edge_index)).to(card)
    before = kops.spmm_csr.launches
    got = prog(xt, eit)
    torch.cuda.synchronize()
    assert kops.spmm_csr.launches == before + 3
    assert torch.equal(got, want)


def _hier_case(seed=12, n=3000, e=40000, F=64):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return ei, w, x


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_hier_tier_at_one_part_on_card_matches_the_cpu(card, dtype, rtol):
    """Forward and x's gradient of <out, c> for a fixed c (so each
    direction rounds once in bf16, whatever the other did) against the
    CPU's plain versions; 1 `spmm_csr` each direction, no class but the
    interior at one part."""
    from gammagl_tpu_torch import parallel as tpar
    ei, w, x = _hier_case()
    part = tpar.build_hier_halo_partition_planned(ei, 3000, 1, 1, w)
    c = torch.randn(part.rows_per, x.shape[1],
                    generator=torch.Generator().manual_seed(3))
    outs, grads = [], []
    for dev in (card, torch.device("cpu")):
        xt = tpar.shard_nodes(x, part, device=dev,
                              dtype=dtype).requires_grad_()
        before = (kops.spmm_csr.launches, kops.spmm_csr_acc.launches)
        out = tpar.make_hier_halo_spmm_planned(part)(xt)
        (out.float() * c.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (kops.spmm_csr.launches - before[0],
                    kops.spmm_csr_acc.launches - before[1]) == (2, 0)
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    _close(outs[0], outs[1], rtol)
    _close(grads[0], grads[1], rtol)


def _gat_case(seed=13, n=2000, e=30000, heads=4, fh=8):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 9, e)])
    h = rng.normal(size=(n, heads * fh)).astype(np.float32)
    a_s = rng.normal(size=(heads, fh)).astype(np.float32) * 0.3
    a_d = rng.normal(size=(heads, fh)).astype(np.float32) * 0.3
    return ei, h, a_s, a_d


def _gat_layer_run(part, heads, h, a_s, a_d, dev, dtype, rank=0):
    from gammagl_tpu_torch import parallel as tpar
    hb = tpar.shard_nodes(h, part, rank=rank, device=dev,
                          dtype=dtype).requires_grad_()
    st = torch.tensor(a_s, device=dev, requires_grad=True)
    at = torch.tensor(a_d, device=dev, requires_grad=True)
    out = tpar.make_partitioned_gat_layer(part, heads)(hb, st, at)
    (out.float() ** 2).sum().backward()
    return out.detach(), hb.grad, st.grad, at.grad


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_partitioned_gat_layer_on_card_matches_the_cpu(card, dtype, rtol):
    """The layer at one part: one flash forward, one flash backward and
    the backward's two SpMM on the edge-scatter plan; output and the
    gradients in h, a_src and a_dst against the CPU's plain versions;
    repeated bitwise."""
    from gammagl_tpu_torch import parallel as tpar
    ei, h, a_s, a_d = _gat_case()
    part = tpar.build_halo_partition_attn(ei, 2000, 1)
    before = (kops.flash_forward.launches, kops.flash_backward.launches,
              kops.spmm_csr.launches)
    got = _gat_layer_run(part, 4, h, a_s, a_d, card, dtype)
    torch.cuda.synchronize()
    after = (kops.flash_forward.launches, kops.flash_backward.launches,
             kops.spmm_csr.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 2)
    again = _gat_layer_run(part, 4, h, a_s, a_d, card, dtype)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = _gat_layer_run(part, 4, h, a_s, a_d, torch.device("cpu"), dtype)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float().cpu(), b.float(), rtol=rtol,
                                   atol=rtol * float(b.float().abs().max()))


def test_partitioned_gat_steps_repeat_bitwise_on_card(card):
    """Two steps of `make_partitioned_gat_train` from one state give
    bitwise equal losses and gradients; a step launches 4 flash forwards
    (remat reruns each layer), 2 flash backwards and 4 SpMM."""
    from gammagl_tpu_torch import parallel as tpar
    ei, h, _, _ = _gat_case(heads=1, fh=24)
    rng = np.random.default_rng(14)
    y = rng.integers(0, 5, 2000)
    m = (rng.random(2000) < 0.5).astype(np.float32)
    part = tpar.build_halo_partition_attn(ei, 2000, 1)
    params, opt, step, _ = tpar.make_partitioned_gat_train(
        part, 24, 8, 5, heads=8, compute_dtype=torch.bfloat16, device=card)
    xs, ys, ms = (tpar.shard_nodes(a, part, device=card) for a in (h, y, m))
    runs = []
    for _ in range(2):
        before = (kops.flash_forward.launches, kops.flash_backward.launches,
                  kops.spmm_csr.launches)
        loss, grads = step.loss_and_grads(params, xs, ys, ms)
        torch.cuda.synchronize()
        after = (kops.flash_forward.launches, kops.flash_backward.launches,
                 kops.spmm_csr.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (4, 2, 4)
        runs.append((loss, grads))
    assert torch.equal(runs[0][0], runs[1][0])
    for k_ in runs[0][1]:
        assert torch.equal(runs[0][1][k_], runs[1][1][k_]), k_


MULTI_WORKER = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
inp, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
d = np.load(inp)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4,
                        timeout=datetime.timedelta(seconds=120))
from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.ops import cuda as k
dev = torch.device("cuda")
res = {}
try:
    probe = torch.ones(4, 2, device=dev)
    dist.all_to_all_single(torch.empty_like(probe), probe)
    dist.all_gather([torch.empty_like(probe) for _ in range(4)], probe)
except RuntimeError as err:
    res["unsupported"] = np.asarray(str(err)[:300])
if "unsupported" not in res:
    n = d["x"].shape[0]
    part = tpar.build_hier_halo_partition_planned(d["ei"], n, 2, 2, d["w"])
    spmm = tpar.make_hier_halo_spmm_planned(part)
    later = [sum(1 for c in (p.intra, p.inter) if c[rank].num_edges)
             for p in (part, part.transpose)]
    for dt in ("f32", "bf16"):
        x = tpar.shard_nodes(d["x"], part, device=dev, dtype={
            "f32": torch.float32, "bf16": torch.bfloat16}[dt])
        x.requires_grad_()
        before = (k.spmm_csr.launches, k.spmm_csr_acc.launches)
        out = spmm(x)
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        res[dt + ":launches"] = np.asarray(
            [k.spmm_csr.launches - before[0],
             k.spmm_csr_acc.launches - before[1], 2, sum(later)])
        res[dt + ":out"] = out.detach().float().cpu().numpy()
        res[dt + ":grad"] = x.grad.float().cpu().numpy()
    gpart = tpar.build_halo_partition_attn(d["gei"], d["gh"].shape[0], 4)
    layer = tpar.make_partitioned_gat_layer(gpart, 4)
    runs = []
    for _ in range(2):
        hb = tpar.shard_nodes(d["gh"], gpart, device=dev).requires_grad_()
        st = torch.tensor(d["gas"], device=dev, requires_grad=True)
        at = torch.tensor(d["gad"], device=dev, requires_grad=True)
        before = (k.flash_forward.launches, k.flash_backward.launches,
                  k.spmm_csr.launches)
        out = layer(hb, st, at)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        res["gat:launches"] = np.asarray(
            [k.flash_forward.launches - before[0],
             k.flash_backward.launches - before[1],
             k.spmm_csr.launches - before[2]])
        runs.append((out.detach(), hb.grad, st.grad, at.grad))
    # the halo rows' gradients come back to their owners through the
    # exchange and `spmm_csr` on the scatter plan: the same bits each time
    res["gat:repeat_equal"] = np.asarray(
        [torch.equal(a, b) for a, b in zip(*runs)])
    out, dh, das, dad = runs[0]
    res["gat:out"] = out.cpu().numpy()
    res["gat:dh"] = dh.cpu().numpy()
    res["gat:das"] = das.cpu().numpy()
    res["gat:dad"] = dad.cpu().numpy()
dist.barrier()
dist.destroy_process_group()
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def test_tiers_in_four_processes_on_one_card(card, tmp_path):
    """Four gloo processes on the one card: the planned two-level tier at
    (2, 2) and the partitioned GAT layer at 4 parts, against the CPU's
    single-process references; each rank's launches (the tier: 1 SpMM and
    one accumulating launch a class with edges, each direction; the
    layer: 1 flash forward, 1 backward, 3 SpMM); the layer's forward and
    backward run twice by each rank, bitwise equal. Skips when this
    torch's gloo refuses CUDA tensors."""
    import subprocess
    import sys
    from pathlib import Path
    from gammagl_tpu_torch import parallel as tpar
    ei, w, x = _hier_case()
    gei, gh, gas, gad = _gat_case()
    inp = tmp_path / "in.npz"
    np.savez(inp, ei=ei, w=w, x=x, gei=gei, gh=gh, gas=gas, gad=gad)
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTI_WORKER, str(inp), str(r),
         str(tmp_path / "store")], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    parts = [dict(np.load(tmp_path / f"in_out{r}.npz")) for r in range(4)]
    if "unsupported" in parts[0]:
        pytest.skip(f"gloo refuses CUDA tensors: {parts[0]['unsupported']}")
    one = tpar.build_hier_halo_partition_planned(ei, 3000, 1, 1, w)
    part = tpar.build_hier_halo_partition_planned(ei, 3000, 2, 2, w)
    for dt, dtype, rtol in (("f32", torch.float32, 1e-5),
                            ("bf16", torch.bfloat16, 2e-2)):
        for p in parts:
            got = p[dt + ":launches"]
            assert (got[0], got[1]) == (got[2], got[3])
        xt = tpar.shard_nodes(x, one, device="cpu",
                              dtype=dtype).requires_grad_()
        out = tpar.make_hier_halo_spmm_planned(one)(xt)
        (out.float() ** 2).sum().backward()
        for key, want in ((":out", out.detach()), (":grad", xt.grad)):
            got = tpar.unpad_nodes(np.concatenate(
                [p[dt + key] for p in parts]), part)
            want = torch.from_numpy(tpar.unpad_nodes(want.float(), one))
            torch.testing.assert_close(
                torch.from_numpy(got), want, rtol=rtol,
                atol=rtol * float(want.abs().max()))
    one = tpar.build_halo_partition_attn(gei, 2000, 1)
    want = _gat_layer_run(one, 4, gh, gas, gad, torch.device("cpu"),
                          torch.float32)
    gpart = tpar.build_halo_partition_attn(gei, 2000, 4)
    for p in parts:
        assert p["gat:launches"].tolist() == [1, 1, 3]
        assert p["gat:repeat_equal"].tolist() == [True] * 4
    got = (np.concatenate([p["gat:out"] for p in parts]),
           np.concatenate([p["gat:dh"] for p in parts]),
           sum(p["gat:das"] for p in parts), sum(p["gat:dad"] for p in parts))
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.float().numpy()
        if i < 2:
            a = a[:2000]
            b = b[:2000]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


# -- the ops of rows 5-15 on the card, and the models exported through them

_OP_COUNTED = ("spmm_csr", "segment_sum_csr", "spmm_csr_acc", "csr_fold",
               "expand_dst_csr", "sddmm_csr", "flash_forward",
               "flash_fwd_fold", "flash_backward", "spmm_max_csr",
               "spmm_min_csr", "segment_max_csr", "segment_min_csr",
               "segment_max_fold", "segment_max_bwd", "segment_max_count",
               "segment_max_count_fold", "hgt_forward", "hgt_backward",
               "spmm_block_pair", "block_pair_dw")


def _op_counts():
    return {name: getattr(kops, name).launches for name in _OP_COUNTED}


def _op_launched(before):
    return {name: n - before[name] for name, n in _op_counts().items()
            if n != before[name]}


def _op_hub_plan(n=300, e=3000, hub=None, seed=50):
    """Random edges with a hub row 0 past ROW_SPLIT (and so EDGE_SPLIT);
    the last 20 rows get none."""
    rng = np.random.default_rng(seed)
    hub = kops.ROW_SPLIT + 77 if hub is None else hub
    src = rng.integers(0, n, e + hub)
    dst = np.concatenate([rng.integers(0, n - 20, e), np.zeros(hub, int)])
    return kops.build_csr_plan(src, dst, n)


def _card_op_args(name, card):
    """One small hub-row case of an op's arguments on the card."""
    from gammagl_tpu_torch.ops.cuda.flash_attention import _plan_args
    from gammagl_tpu_torch.ops.cuda.segment_matmul import _op_args
    plan = _op_hub_plan()
    n, E = plan.num_nodes, plan.num_edges
    g = torch.Generator(device=card).manual_seed(51)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=card).to(dtype)
    bf = torch.bfloat16
    if name in ("spmm_csr_acc", "spmm_csr_acc_out"):
        x, prev = rand(n, 16, dtype=bf), rand(n, 16, dtype=bf)
        w = torch.rand(E, generator=g, device=card)
        if name == "spmm_csr_acc":
            return (x, w, prev, *_op_args(plan, card))
        return (x, w, prev, torch.empty_like(prev), *_op_args(plan, card))
    if name in ("sddmm_csr", "expand_dst_csr"):
        items = _edge_items(plan, card)
        if name == "sddmm_csr":
            return (rand(n, 16, dtype=bf), rand(n, 16, dtype=bf), *items, 2,
                    True)
        return (rand(n, 16, dtype=bf), torch.rand(E, 2, generator=g,
                                                  device=card), *items)
    if name in ("flash_forward", "flash_backward"):
        score, a_dst, msg = rand(n, 2), rand(n, 2), rand(n, 16, dtype=bf)
        keep = (torch.rand(E, 2, generator=g, device=card) < 0.7).float()
        if name == "flash_forward":
            return (score, a_dst, msg, keep, *_plan_args(plan, card), 0.2,
                    True)
        out, m, l = kops.flash_forward(score, a_dst, msg, keep, plan, 0.2,
                                       True)
        return (score, a_dst, msg, keep, m, l, out, rand(n, 16, dtype=bf),
                *plan.arrays(card), 0.2, True)
    if name in ("segment_extreme", "segment_max_bwd"):
        x = torch.randint(-3, 4, (n, 16), generator=g, device=card).to(bf)
        w = torch.randint(1, 3, (E,), generator=g, device=card).float()
        if name == "segment_extreme":
            return (x, w, *_op_args(plan, card), False, False)
        out = kops.spmm_max_csr(x, w, plan, weights_padded=True)
        return (x, w, out, rand(n, 16, dtype=bf), *_op_args(plan, card),
                False, True)
    if name in ("hgt_forward", "hgt_backward"):
        kv, q = rand(n, 64, dtype=bf), rand(n, 2, 16, dtype=bf)
        rowptr, col, _ = plan.arrays(card)
        if name == "hgt_forward":
            return (kv, q, rowptr, col)
        out, m, l = kops.hgt_forward(kv, q, plan)
        return (kv, q, out, rand(n, 32, dtype=bf), m, l, rowptr, col)
    rng = np.random.default_rng(52)
    dst = rng.integers(0, n, 4000)
    src = np.clip(dst + rng.integers(-40, 41, 4000), 0, n - 1)
    bp = kops.build_block_pair_plan(src, dst, n, R=64, S=64)
    row, col, w_perm, block_ptr, pair_src, row_ptr, _ = bp.arrays(card)
    x = rand(n, 16, dtype=bf)
    if name == "spmm_block_pair":
        return (x, torch.rand(bp.num_edges, generator=g, device=card), w_perm,
                row, col, block_ptr, pair_src, row_ptr, bp.num_nodes,
                bp.num_src, bp.R, bp.S)
    return (x, rand(n, 16, dtype=bf), row, col, w_perm, bp.num_edges)


@pytest.mark.parametrize("name", [
    "spmm_csr_acc", "spmm_csr_acc_out", "sddmm_csr", "expand_dst_csr",
    "flash_forward", "flash_backward", "segment_extreme", "segment_max_bwd",
    "hgt_forward", "hgt_backward", "spmm_block_pair", "block_pair_dw"])
def test_ops_pass_opcheck_on_card(card, name):
    """``torch.library.opcheck`` of each op of rows 5-15 on CUDA tensors
    (bf16 rows, a hub row cut into work items), so the fake shapes hold
    for the kernels' outputs too."""
    torch.library.opcheck(getattr(torch.ops.gammagl, name).default,
                          _card_op_args(name, card))


def _export_case(family):
    """(model, example inputs, forward keywords, compute dtype, the
    kernels' launches a request) of one row family."""
    rng = np.random.default_rng(53)
    n, e = 2000, 16000
    x = rng.normal(size=(n, 24)).astype(np.float32)
    graph = Graph(x=x, edge_index=rng.integers(0, n, (2, e))).add_self_loop()
    ei = graph.edge_index
    torch.manual_seed(54)
    if family == "flash":
        return (GATModel(hidden_dim=8, num_class=5, heads=4, in_channels=24),
                (x, ei), {"plan": graph.csr_plan()}, torch.bfloat16,
                {"flash_forward": 2})
    if family == "expand":
        return (GATV2Model(hidden_dim=8, num_class=5, heads=4), (x, ei),
                {"plan": graph.csr_plan()}, torch.float32,
                {"expand_dst_csr": 2, "flash_forward": 2})
    if family == "segment_max":
        return (GraphSAGEModel(16, 5, num_layers=2, aggr="max"), (x, ei),
                {"plan": graph.csr_plan()}, torch.bfloat16,
                {"spmm_max_csr": 2})
    if family == "hgt":
        hg, target = synthetic_hetero(0)
        return (HGTModel(hg.metadata(), 128, 3, target, heads=2,
                         dtype=torch.bfloat16),
                (dict(hg.x_dict), dict(hg.edge_index_dict)),
                {"plan_dict": hg.csr_plans(window=True)}, None,
                {"hgt_forward": 2 * len(hg.edge_types)})
    dst = rng.integers(0, 4096, 40000)
    src = np.clip(dst + rng.integers(-64, 65, 40000), 0, 4095)
    band = Graph(x=rng.normal(size=(4096, 24)).astype(np.float32),
                 edge_index=np.stack([src, dst]))
    plan = band.auto_plan()
    assert isinstance(plan, kops.BlockPairPlan), plan
    return (GCNModel(hidden_dim=16, num_class=5), (band.x, band.edge_index),
            {"plan": plan}, torch.bfloat16, {"spmm_block_pair": 2})


@pytest.mark.parametrize("family", ["flash", "expand", "segment_max", "hgt",
                                    "block_pair"])
def test_exported_model_runs_its_kernels_from_a_file(card, tmp_path,
                                                     family):
    """One model a row family exported on the card, saved and loaded: its
    output bitwise the live session's, and a request launches exactly the
    kernels the live request launches."""
    from gammagl_tpu_torch.serve import (export_forward, load_exported,
                                         save_exported)
    model, inputs, kwargs, dtype, per_request = _export_case(family)
    sess = InferenceSession(model, inputs, device="cuda",
                            compute_dtype=dtype, **kwargs)
    torch.cuda.synchronize()
    before = _op_counts()
    want = sess(*inputs)
    torch.cuda.synchronize()
    assert _op_launched(before) == per_request
    ep = export_forward(model, inputs, device="cuda", compute_dtype=dtype,
                        **kwargs)
    save_exported(ep, tmp_path / "model.pt2")
    prog = load_exported(tmp_path / "model.pt2")
    placed = tuple(sess._place_raw(a) if not isinstance(a, dict) else
                   {k: sess._place_raw(v) for k, v in a.items()}
                   for a in inputs)
    prog(*placed)
    torch.cuda.synchronize()
    before = _op_counts()
    got = prog(*placed)
    torch.cuda.synchronize()
    assert _op_launched(before) == per_request
    assert torch.equal(got, want)


def test_two_gat_steps_through_the_ops_repeat_bitwise_c39(card):
    """ROADMAP C39 through the ops: two Adam steps of a GATModel from one
    state (parameters, optimizer, masks and generator) give bitwise equal
    losses and parameters; a step launches 2 flash forwards, 2 flash
    backwards and 4 SpMM."""
    rng = np.random.default_rng(55)
    n, e = 3000, 40000
    x = rng.normal(size=(n, 24)).astype(np.float32)
    graph = Graph(x=x, edge_index=np.stack(
        [rng.integers(0, 50, e), rng.integers(0, n, e)])).add_self_loop()
    xt = torch.tensor(x, device=card)
    ei = torch.tensor(graph.edge_index, device=card)
    plan = graph.csr_plan()
    g = torch.Generator(device=card).manual_seed(56)
    keeps = [kops.attention_keep_mask(g, 0.6, (ei.shape[1], h), card)
             for h in (8, 1)]
    torch.manual_seed(57)
    base = GATModel(hidden_dim=8, num_class=5, heads=8, in_channels=24,
                    dtype=torch.bfloat16).to(card).train()
    y = torch.arange(n, device=card) % 5
    runs = []
    for _ in range(2):
        model = copy.deepcopy(base)
        opt = torch.optim.Adam(model.parameters(), lr=5e-3)
        losses = []
        for step in range(2):
            before = _op_counts()
            opt.zero_grad()
            gen = torch.Generator(device=card).manual_seed(58 + step)
            out = model(xt, ei, plan=plan, keeps=keeps, generator=gen)
            loss = torch.nn.functional.cross_entropy(out.float(), y)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            assert _op_launched(before) == {"flash_forward": 2,
                                         "flash_backward": 2, "spmm_csr": 4}
            losses.append(loss.detach())
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (la, pa), (lb, pb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# -- the dry run's relation attention and dp x tp step in one process ---------

def _dry_het_case(R=3, n=400, d=16, e=3000, seed=26):
    """R relations over n nodes (the last relation: half the rows empty),
    x and the k, q, v weights, as `entry._hetero_case` draws them."""
    rng = np.random.default_rng(seed)
    rel_ei = [np.stack([rng.integers(0, n, e),
                        rng.integers(0, n // (2 if r == R - 1 else 1), e)])
              for r in range(R)]
    x = rng.normal(size=(n, d)).astype(np.float32)
    wk, wq, wv = ((rng.normal(size=(R, d, d)) * 0.4).astype(np.float32)
                  for _ in range(3))
    return rel_ei, x, wk, wq, wv


def _dry_close(got, want, rtol=1e-5):
    got, want = got.detach().cpu(), want.detach().cpu()
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=rtol,
                          atol=1e-5 * float(want.abs().max()))


def test_dry_relation_attention_on_card_matches_the_cpu(card):
    """`entry.hetero_step` with every relation in one process: the output
    and the gradients of x and wk on the card against the plain versions
    on the CPU; each relation launches `spmm_csr` once forward and once
    backward (dv on the transpose) and the gathered SDDMM once (row 8:
    the softmax weights' gradient)."""
    from gammagl_tpu_torch import entry
    rel_ei, x, wk, wq, wv = _dry_het_case()
    before = _op_counts()
    got = entry.hetero_step(rel_ei, x, wk, wq, wv, card)
    torch.cuda.synchronize()
    assert _op_launched(before) == {"spmm_csr": 2 * len(rel_ei),
                                    "sddmm_csr": len(rel_ei)}
    want = entry.hetero_step(rel_ei, x, wk, wq, wv, torch.device("cpu"))
    for g, w in zip(got, want):
        _dry_close(g, w, rtol=1e-4)


def test_dry_softmax_weighted_spmm_and_its_dalpha_on_card(card):
    """Row 1 with the softmax as edge weights in CSR order, and row 8 in
    its backward: out and d alpha = <v[src], g[dst]> against the plain
    versions on the same inputs."""
    from gammagl_tpu_torch.entry import relation_attention
    rel_ei, x, wk, wq, wv = _dry_het_case(R=1)
    plan = kops.build_csr_plan(rel_ei[0][0], rel_ei[0][1], x.shape[0])
    rng = np.random.default_rng(27)
    v = torch.tensor(rng.normal(size=x.shape).astype(np.float32))
    alpha = torch.tensor(rng.random(plan.num_edges).astype(np.float32))
    g = torch.tensor(rng.normal(size=x.shape).astype(np.float32))
    a_c = alpha.to(card).requires_grad_()
    out = kops.spmm_csr(v.to(card), a_c, plan, weights_padded=True)
    out.backward(g.to(card))
    a_p = alpha.clone().requires_grad_()
    ref = kops.spmm_csr(v, a_p, plan, weights_padded=True)
    ref.backward(g)
    _dry_close(out, ref)
    _dry_close(a_c.grad, a_p.grad)
    src = torch.from_numpy(plan.col).long()
    dst = torch.repeat_interleave(torch.arange(plan.num_nodes),
                                  torch.from_numpy(np.diff(plan.rowptr)))
    _dry_close(a_c.grad, (v[src] * g[dst]).sum(-1))
    xs = torch.tensor(x, device=card)
    o = relation_attention(xs, *(torch.tensor(w[0], device=card)
                                 for w in (wk, wq, wv)), plan)
    assert torch.isfinite(o).all() and o.shape == x.shape


def test_dry_dp_tp_step_on_card_matches_the_cpu(card):
    """`entry.dp_tp_step` on the (1, 1) grid: loss and both gradients on
    the card (4 `spmm_csr`: two layers forward, their dx backward)
    against the CPU."""
    from gammagl_tpu_torch import entry
    from gammagl_tpu_torch.parallel import DpTpGrid
    one = DpTpGrid(0, 0, None, None, 1, 1)
    case = entry._gcn_case(False)
    before = _op_counts()
    got = entry.dp_tp_step(one, *case[:2], case[3], case[2], *case[4:],
                           card)
    torch.cuda.synchronize()
    assert _op_launched(before) == {"spmm_csr": 4}
    want = entry.dp_tp_step(one, *case[:2], case[3], case[2], *case[4:],
                            torch.device("cpu"))
    for g, w in zip(got, want):
        _dry_close(g, w, rtol=1e-4)
