"""The wave-2 trainer twins (`gammagl_tpu_torch/examples/`: pna, gaan,
film, gmm, dna, hcha, compgcn, dgcnn) against the JAX trainers of
`examples/<name>/<name>_trainer.py`.

Each twin has the JAX script's flags and defaults (read from its
``__main__`` block by AST), builds the model the JAX script builds
(captured from its ``main``, or its ``Net``), and 3 steps of its loop
from the JAX init, dropout off (the two packages draw their masks from
different generators), give the JAX trainer's losses at rtol 1e-5. The
convs take no plan in either package, so both sum on their COO ops.
"""

import argparse
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jax_common  # noqa: E402
from examples.compgcn import compgcn_trainer as jax_compgcn  # noqa: E402
from examples.dgcnn import dgcnn_trainer as jax_dgcnn  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import (_tiny_data, jax_losses,  # noqa
                                           jax_twin)

from gammagl_tpu_torch.examples import (  # noqa: E402
    compgcn_trainer, dgcnn_trainer, dna_trainer, film_trainer, gaan_trainer,
    gmm_trainer, hcha_trainer, pna_trainer)

NODE_TWINS = {"pna": pna_trainer, "gaan": gaan_trainer,
              "film": film_trainer, "gmm": gmm_trainer, "dna": dna_trainer,
              "hcha": hcha_trainer}
TWINS = {**NODE_TWINS, "compgcn": compgcn_trainer, "dgcnn": dgcnn_trainer}


def _same_flags(module, name):
    jmod, jargs = jax_twin(name)
    targs = module.parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    return jmod, jargs, targs


@pytest.mark.parametrize("name", sorted(NODE_TWINS))
def test_node_twin_matches_the_jax_trainer(name, monkeypatch):
    module = NODE_TWINS[name]
    jmod, jargs, targs = _same_flags(module, name)
    data = _tiny_data(8)
    n_class = int(data["y"].max()) + 1
    monkeypatch.setattr(jmod, "probe_num_classes", lambda args: n_class)
    monkeypatch.setattr(jmod, "run_simple_node_trainer",
                        lambda model, args, **kw: model)
    jargs.drop_rate = targs.drop_rate = 0.0
    targs.n_epoch = 3
    want, params = jax_losses(jmod.main(jargs), data, jargs, 3)
    got = module.main(targs, data=data, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def _jax_steps(model, params, loss_of_logits, lr, n_steps, *inputs):
    """n_steps of Adam (``lr``, no decay) on ``loss_of_logits`` of the
    model's forward, as the compgcn and dgcnn trainers step, under one
    jit. The forward runs in ``ensure_compile_time_eval``: the inputs are
    constants of the trace, so what the model computes from them alone
    (the dgcnn model's sort pool sizes its batch from ``batch``) is
    evaluated while tracing, as the dgcnn trainer's eager step does."""
    state = JaxTrainState.create(params=params, tx=optax.adam(lr))

    def forward(p):
        with jax.ensure_compile_time_eval():
            return model.apply(p, *inputs)

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(lambda p: loss_of_logits(
            forward(p)))(state.params)
        return state.apply_gradients(grads), loss

    losses = []
    for _ in range(n_steps):
        state, loss = step(state)
        losses.append(float(loss))
    return losses


def test_compgcn_twin_matches_the_jax_trainer():
    """The JAX trainer's typed graph (its ``typed_graph``) equals the
    twin's, and 3 steps from the JAX init give the JAX losses."""
    _, jargs, targs = _same_flags(compgcn_trainer, "compgcn")
    x, ei, et, y, n_m, n_rel, train_mask, _ = jax_compgcn.typed_graph(jargs)
    data = compgcn_trainer.typed_graph()
    for key, want in (("x", x), ("edge_index", ei), ("edge_type", et),
                      ("y", y), ("train_mask", train_mask)):
        np.testing.assert_array_equal(data[key], np.asarray(want))
    assert (data["num_movies"], data["num_relations"]) == (n_m, n_rel)
    jm = jax_compgcn.CompGCNModel(num_relations=n_rel,
                                  hidden_dim=jargs.hidden_dim,
                                  num_class=int(np.asarray(y).max()) + 1)
    key = jax.random.PRNGKey(jargs.seed)
    params = jm.init({"params": key, "dropout": key}, x, ei, et)
    want = _jax_steps(jm, params, lambda out: jax_loss(
        out[:n_m], y, train_mask), jargs.lr, 3, x, ei, et)
    targs.n_epoch = 3
    got = compgcn_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def test_dgcnn_twin_matches_the_jax_trainer():
    """The JAX trainer's batch (its ``graph_batch``, 32 graphs) equals the
    twin's, and 3 steps from the JAX init give the JAX losses."""
    _, jargs, targs = _same_flags(dgcnn_trainer, "dgcnn")
    x, ei, batch, y, ng = jax_dgcnn.graph_batch(jargs)
    data = dgcnn_trainer.graph_batch(targs.num_graphs)
    for key, want in (("x", x), ("edge_index", ei), ("batch", batch),
                      ("y", y)):
        np.testing.assert_array_equal(data[key], np.asarray(want))
    jm = jax_dgcnn.DGCNNModel(hidden_dim=jargs.hidden_dim, num_class=2, k=6)
    params = jm.init(jax.random.PRNGKey(jargs.seed), x, ei, batch, ng)
    want = _jax_steps(
        jm, params, lambda out: optax.softmax_cross_entropy_with_integer_labels(
            out, y).mean(), jargs.lr, 3, x, ei, batch, ng)
    targs.n_epoch = 3
    got = dgcnn_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def _run(name, n_epoch):
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                       str(n_epoch)])
    if name in NODE_TWINS:
        return module.main(args, data=_tiny_data(10))
    if name == "dgcnn":
        args.num_graphs = 8
    return module.main(args)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_trains_on_the_cpu_with_dropout(name, capsys):
    """The twin's own init (dropout on where the model has it): the run
    ends, the losses are finite, the accuracies are fractions."""
    out = _run(name, 4)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    acc = out.get("best_test", out.get("test_acc", out.get("train_acc")))
    assert 0.0 <= acc <= 1.0
    assert "acc" in capsys.readouterr().out or name in NODE_TWINS


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"data": _tiny_data(11)} if name in NODE_TWINS else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]), **kw)
