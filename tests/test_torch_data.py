"""The port's Graph container, self-loops and MessagePassing protocol
against the JAX package."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.layers.conv import MessagePassing
from gammagl_tpu_torch.utils import add_self_loops


def _edges(seed=0, n=30, e=90):
    return np.random.default_rng(seed).integers(0, n, (2, e))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("n_loops", [1, 2])
def test_add_self_loops_matches_jax(kind, n_loops):
    ei = _edges()
    attr = np.random.default_rng(1).random((ei.shape[1], 3)).astype(
        np.float32)
    want_ei, want_attr = jax_add_self_loops(ei, attr, fill_value=2.0,
                                            num_nodes=35, n_loops=n_loops)
    arg = (ei, attr) if kind == "numpy" else (torch.from_numpy(ei),
                                              torch.from_numpy(attr))
    got_ei, got_attr = add_self_loops(*arg, fill_value=2.0, num_nodes=35,
                                      n_loops=n_loops)
    assert type(got_ei) is type(arg[0])
    np.testing.assert_array_equal(np.asarray(got_ei), np.asarray(want_ei))
    np.testing.assert_array_equal(np.asarray(got_attr),
                                  np.asarray(want_attr))
    assert got_ei.dtype == arg[0].dtype


def test_graph_sizes_and_self_loops_match_jax():
    ei = _edges(2)
    x = np.zeros((40, 3), np.float32)
    for kw in ({"x": x}, {"num_nodes": 45}, {}):
        g, jg = Graph(edge_index=ei, **kw), JaxGraph(edge_index=ei, **kw)
        assert g.num_nodes == jg.num_nodes and g.num_edges == jg.num_edges
        looped = g.add_self_loop()
        np.testing.assert_array_equal(looped.edge_index,
                                      np.asarray(jg.add_self_loop().edge_index))
        assert g.num_edges == ei.shape[1]  # the original is untouched
    g = Graph(x=x, edge_index=ei, edge_attr=np.zeros((ei.shape[1], 2)))
    looped = g.add_self_loop()
    assert looped.edge_attr.shape == (ei.shape[1] + 40, 2)
    assert (looped.edge_attr[ei.shape[1]:] == 1).all()
    assert looped.x is x and "Graph(x=[40, 3]" in repr(looped)
    with pytest.raises(AttributeError):
        g.y  # noqa: B018


def test_csr_plan_is_cached_and_not_shared_by_copies():
    g = Graph(edge_index=_edges(3), num_nodes=30)
    plan = g.csr_plan()
    assert g.csr_plan() is plan
    assert g.csr_plan(R=8, ET=32, window=False) is plan
    assert g.clone().csr_plan() is not plan
    assert plan.num_nodes == plan.num_src == 30
    assert plan.num_edges == 90


class _Doubled(MessagePassing):
    """Overrides `message`, so propagate takes the unfused path."""

    def message(self, x, edge_index, edge_weight=None):
        return 2 * super().message(x, edge_index, edge_weight)

    def forward(self, x, edge_index, edge_weight=None, aggr="sum"):
        return self.propagate(x, edge_index, aggr=aggr,
                              edge_weight=edge_weight)


class _Fused(MessagePassing):
    def forward(self, x, edge_index, edge_weight=None, aggr="sum"):
        return self.propagate(x, edge_index, aggr=aggr,
                              edge_weight=edge_weight)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_unfused_path_matches_fused_path(aggr):
    ei = torch.from_numpy(_edges(4))
    x = torch.randn(30, 5, generator=torch.Generator().manual_seed(0))
    w = torch.rand(ei.shape[1], generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(_Doubled()(x, ei, w, aggr),
                               2 * _Fused()(x, ei, w, aggr))
    with pytest.raises(NotImplementedError):
        _Doubled()(x, ei, w, "min")
