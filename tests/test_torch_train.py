"""The port's training pieces against the JAX package: the loss and metric,
Adam with decayed weights, checkpoints, and the fusedgat trainer twin
(`gammagl_tpu_torch.examples.fusedgat_trainer`) against the step of
`examples/fusedgat/fusedgat_trainer.py`, and the gat, gatv2 and gcn twins
(`gammagl_tpu_torch.examples.{gat,gatv2,gcn}_trainer`, one shared loop)
against the steps of `examples/{gat,gatv2,gcn}/*_trainer.py`.

Tolerances: metrics 1e-6 relative (float32, one formula); parameters
after Adam steps 1e-6 (the two libraries order the update's float32
operations differently, about 2e-7 after 4 steps of lr 0.01); the
twins' loss curves rtol 1e-4 against the JAX trainers (the fusedgat
plan path runs the Pallas kernels in interpret mode, bf16x3 products;
the gat, gatv2 and gcn twins run the port's plan path, plain on the CPU,
against the JAX trainers' XLA path, which they take off a TPU).
A checkpoint resumes bit for bit.
"""

import argparse

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from examples.fusedgat import fusedgat_trainer as jax_trainer
from gammagl_tpu.datasets import synthetic_community_graph as jax_synthetic
from gammagl_tpu.models import GATModel as JaxGATModel
from gammagl_tpu.models import GATV2Model as JaxGATV2Model
from gammagl_tpu.models import GCNModel as JaxGCNModel
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.train import TrainState as JaxTrainState
from gammagl_tpu.train import accuracy as jax_accuracy
from gammagl_tpu.train import semi_supervised_loss as jax_loss
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops

from gammagl_tpu_torch.examples import fusedgat_trainer as twin
from gammagl_tpu_torch.examples import (gat_trainer, gatv2_trainer,
                                        gcn_trainer, hgt_trainer)
from gammagl_tpu_torch.train import (TrainState, accuracy, load_checkpoint,
                                     save_checkpoint, semi_supervised_loss)


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 50)
    mask = rng.random(50) < 0.4
    got = semi_supervised_loss(torch.tensor(logits), torch.tensor(labels),
                               torch.tensor(mask))
    want = jax_loss(jnp.asarray(logits), jnp.asarray(labels),
                    jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for m in (None, mask):
        got = accuracy(torch.tensor(logits), torch.tensor(labels),
                       None if m is None else torch.tensor(m))
        want = jax_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = torch.zeros(50, dtype=torch.bool)
    assert float(semi_supervised_loss(torch.tensor(logits),
                                      torch.tensor(labels), empty)) == 0.0


def test_loss_broadcasts_one_row_as_jax_c17():
    """ROADMAP C17: one row of logits (1, C), as a model that pools the
    whole graph gives, against labels (N,): every label takes that row,
    as optax's loss and JAX's accuracy broadcast it."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(1, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 40)
    mask = rng.random(40) < 0.5
    got = semi_supervised_loss(torch.tensor(logits), torch.tensor(labels),
                               torch.tensor(mask))
    want = jax_loss(jnp.asarray(logits), jnp.asarray(labels),
                    jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for m in (None, mask):
        got = accuracy(torch.tensor(logits), torch.tensor(labels),
                       None if m is None else torch.tensor(m))
        want = jax_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("l2", [0.0, 5e-4])
def test_adam_with_decayed_weights_matches_optax(l2):
    """torch Adam(weight_decay=l2) adds l2 * param to the gradient before
    the moments: optax.chain(add_decayed_weights(l2), adam(lr))."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(4)]
    tx = optax.chain(optax.add_decayed_weights(l2), optax.adam(0.01))
    update = jax.jit(tx.update)
    params = jnp.asarray(p0)
    opt = tx.init(params)
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(p0))
    state = TrainState(model, 0.01, l2)
    for g in grads:
        upd, opt = update(jnp.asarray(g), opt, params)
        params = optax.apply_updates(params, upd)
        model.weight.grad = torch.tensor(g)
        state.apply_gradients()
    assert state.step == 4 and model.weight.grad is None
    np.testing.assert_allclose(model.weight.detach().numpy(),
                               np.asarray(params), rtol=1e-6, atol=1e-6)


def _tiny_data(seed=3):
    return twin.synthetic_community_graph(num_nodes=60, num_classes=4,
                                          feat_dim=12, avg_degree=4,
                                          seed=seed)


def _args(**kw):
    args = twin.parser().parse_args(["--device", "cpu"])
    for k, v in dict(n_epoch=5, hidden_dim=4, heads=2, **kw).items():
        setattr(args, k, v)
    return args


def test_twin_loss_curve_matches_the_jax_trainer():
    """Same graph, same initial params, no dropout, f32: 5 full-batch
    steps of the JAX trainer's step and of the twin."""
    data = _tiny_data()
    n = data["x"].shape[0]
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    plan = jax_build_csr_plan(ei[0], ei[1], n)
    x, jei = jnp.asarray(data["x"]), jnp.asarray(ei)
    y, mask = jnp.asarray(data["y"]), jnp.asarray(data["train_mask"])
    model = jax_trainer.FusedGAT(hidden_dim=4, heads=2, num_class=4)
    params = jax.jit(lambda key: model.init(key, x, jei, plan))(
        jax.random.PRNGKey(0))
    state = JaxTrainState.create(params=params, tx=optax.adam(0.005))

    @jax.jit
    def step(state, x, ei, y, train_mask):
        loss, grads = jax.value_and_grad(
            lambda p: jax_loss(model.apply(p, x, ei, plan), y,
                               train_mask))(state.params)
        return state.apply_gradients(grads), loss

    want = []
    for _ in range(5):
        state, loss = step(state, x, jei, y, mask)
        want.append(float(loss))
    got = twin.main(_args(), data=data,
                    params=jax.tree_util.tree_map(np.asarray, params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    data = _tiny_data(4)
    n = data["x"].shape[0]
    ei = torch.tensor(np.concatenate(
        [data["edge_index"], np.stack([np.arange(n)] * 2)], 1))
    plan = twin.build_csr_plan(ei[0].numpy(), ei[1].numpy(), n)
    x = torch.tensor(data["x"])
    y, mask = torch.tensor(data["y"]), torch.tensor(data["train_mask"])

    def fresh():
        torch.manual_seed(5)
        return TrainState(twin.FusedGAT(4, 2, 4, in_channels=12), 0.01,
                          l2=5e-4)

    def steps(state, k):
        return [float(twin.train_step(state, x, ei, y, mask, plan))
                for _ in range(k)]

    state = fresh()
    steps(state, 3)
    path = tmp_path / "ckpt.pt"
    save_checkpoint(path, state)
    want = steps(state, 2)
    want_params = [p.detach().clone() for p in state.model.parameters()]
    restored = load_checkpoint(path, fresh())
    assert restored.step == 3
    assert steps(restored, 2) == want and restored.step == 5
    for a, b in zip(restored.model.parameters(), want_params):
        assert torch.equal(a, b)


def test_twin_graph_is_the_jax_synthetic_graph():
    g = jax_synthetic(1000, 7, 128, avg_degree=8, seed=6)
    d = twin.synthetic_community_graph(seed=6)
    np.testing.assert_array_equal(d["edge_index"], np.asarray(g.edge_index))
    for k in ("x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(d[k], np.asarray(g[k]))


def test_twin_command_line_runs_on_the_cpu(capsys):
    args = twin.parser().parse_args(["--n_epoch", "2", "--hidden_dim", "4",
                                     "--heads", "2", "--device", "cpu"])
    assert isinstance(args, argparse.Namespace) and args.lr == 0.005
    out = twin.main(args, data=_tiny_data(7))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["test_acc"] <= 1.0
    assert "final test acc" in capsys.readouterr().out


TWINS = {"gat": (gat_trainer, lambda n_class: JaxGATModel(
             hidden_dim=4, num_class=n_class, heads=8, drop_rate=0.0)),
         "gatv2": (gatv2_trainer, lambda n_class: JaxGATV2Model(
             hidden_dim=4, num_class=n_class, heads=8, drop_rate=0.0)),
         "gcn": (gcn_trainer, lambda n_class: JaxGCNModel(
             hidden_dim=4, num_class=n_class, drop_rate=0.0))}


def _twin_args(module, *argv):
    return module.parser().parse_args(["--device", "cpu", "--hidden_dim",
                                       "4", *argv])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_simple_twin_loss_curve_matches_the_jax_trainer(name):
    """Same graph with self-loops, same initial params, dropout off, f32:
    5 steps of the JAX trainers' step (Adam with decayed weights on the
    masked cross-entropy) and of the twin."""
    module, jax_model = TWINS[name]
    data = _tiny_data(8)
    n = data["x"].shape[0]
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    x, jei = jnp.asarray(data["x"]), jnp.asarray(ei)
    y, mask = jnp.asarray(data["y"]), jnp.asarray(data["train_mask"])
    model = jax_model(int(data["y"].max()) + 1)
    args = _twin_args(module, "--n_epoch", "5", "--drop_rate", "0.0")
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x,
                                          jei))(key)
    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = JaxTrainState.create(params=params, tx=tx)

    @jax.jit
    def step(state, x, ei, y, train_mask):
        loss, grads = jax.value_and_grad(lambda p: jax_loss(model.apply(
            p, x, ei, train=True, rngs={"dropout": key}), y,
            train_mask))(state.params)
        return state.apply_gradients(grads), loss

    want = []
    for _ in range(5):
        state, loss = step(state, x, jei, y, mask)
        want.append(float(loss))
    got = module.main(args, data=data,
                      params=jax.tree_util.tree_map(np.asarray, params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_simple_twin_trains_with_dropout(name, tmp_path, capsys):
    """Dropout on (the trainers' defaults), the twin's own init: the run
    ends, the loss falls, the accuracies are fractions."""
    module = TWINS[name][0]
    argv = ["--n_epoch", "30", "--lr", "0.02"]
    if name == "gcn":
        argv += ["--best_model_path", str(tmp_path / "best.pt")]
    args = _twin_args(module, *argv)
    assert args.drop_rate == (0.6 if name == "gat" else 0.5)
    assert args.device == "cpu"
    out = module.main(args, data=_tiny_data(9))
    losses = out["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0]
    assert 0.0 <= out["best_test"] <= 1.0 and 0.0 <= out["best_val"] <= 1.0
    assert "best val" in capsys.readouterr().out
    if name == "gcn":
        ckpt = torch.load(tmp_path / "best.pt", weights_only=True)
        assert ckpt["step"] == 30 and "opt_state" in ckpt


@pytest.mark.parametrize("module", [twin, gat_trainer, gatv2_trainer,
                                    gcn_trainer, hgt_trainer])
def test_twins_default_to_the_card(module, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    rather than falling back to the CPU (the hgt twin before it reads the
    data it is handed)."""
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]),
                    data=_tiny_data(10))
