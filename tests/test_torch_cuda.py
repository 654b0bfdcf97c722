"""Card-only tests of the port: the CSR SpMM kernel against its plain
version, the launch count, the wrapper's checks, and the serving path.

Every test is marked ``cuda`` and skips without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, elementwise, |kernel - plain| <= rtol*|plain| + 1e-5*max|plain|
(the second term for the two f32 summation orders): f32 rtol 1e-5; bf16
rtol 1e-2, one bf16 ulp, since both round once from f32.
"""

import numpy as np
import pytest
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.serve import InferenceSession

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
    cpu = InferenceSession(model, (x, graph.edge_index),
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
