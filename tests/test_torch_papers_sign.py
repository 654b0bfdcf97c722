"""The papers twin's ``--recipe sign`` (`examples/papers100m_trainer.py`
`_train_sign`) against the JAX twin's SIGN branch
(`examples/papers100m/papers100m_trainer.py:279-330`) at one and two
processes.

The port runs the twin in this process (one part) and as two ``python -m``
processes in a launcher's ``env://`` group (gloo), where the K halo
sweeps and the loss's sums over parts cross processes; JAX runs its
recipe, as the twin does off the TPU (the flat halo partition with the
balanced relabeling), on two virtual devices (its losses on one device
differ from these in the seventh digit). Both at
``--scale 0.0005 --hops 2 --f32 --hidden 64 --epochs 6``: the first loss
at rtol 1e-6, all six at rtol 1e-4 (the papers twin's f32 tolerance
against the JAX recipe, `test_torch_full_graph.py`: AdamW's first steps
carry the sums' rounding, 1.6e-5 by the sixth), and the loss falls.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from gammagl_tpu import parallel as jpar
from gammagl_tpu.utils import calc_gcn_norm_np as jnorm
from gammagl_tpu_torch.examples import papers100m_trainer as twin
from tests.test_torch_full_graph import REPO, _jax_example

ARGV = ["--device", "cpu", "--recipe", "sign", "--scale", "0.0005",
        "--hops", "2", "--f32", "--hidden", "64", "--epochs", "6"]
HOPS, HIDDEN, LR, EPOCHS = 2, 64, 1e-2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@functools.lru_cache(maxsize=None)
def _jax_sign(P):
    """The JAX twin's SIGN losses on P devices (its lines; in f32 its
    casts to the compute dtype are identities)."""
    ei, x, y, train, _, c = _jax_example().synthetic_papers(0.0005)
    n = x.shape[0]
    ei = np.concatenate(
        [np.asarray(ei), np.tile(np.arange(n, dtype=np.int64), (2, 1))], 1)
    w = jnorm(ei, n)
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("dp",))
    part = jpar.build_halo_partition(np.asarray(ei), n, P, w, balance=True)
    xs = jpar.shard_nodes(x, mesh, part, dtype=np.float32)
    ys = jpar.shard_nodes(y, mesh, part)
    ms = jpar.shard_nodes(train.astype(np.float32), mesh, part)
    feats = jnp.concatenate(jpar.sign_precompute(
        mesh, part, xs, HOPS, store_dtype=jnp.float32), axis=1)
    rng = np.random.default_rng(0)
    d_in = feats.shape[1]
    params = {
        "w1": jnp.asarray(rng.normal(size=(d_in, HIDDEN))
                          * (2.0 / d_in) ** 0.5, jnp.float32),
        "b1": jnp.zeros(HIDDEN, jnp.float32),
        "w2": jnp.asarray(rng.normal(size=(HIDDEN, c))
                          * (2.0 / HIDDEN) ** 0.5, jnp.float32),
        "b2": jnp.zeros(c, jnp.float32),
    }
    opt = optax.adamw(LR)
    opt_state = opt.init(params)

    def fwd(p, h):
        h = jax.nn.relu(h @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    @jax.jit
    def step(p, s, h, y, m):
        def loss_fn(p):
            ls = optax.softmax_cross_entropy_with_integer_labels(
                fwd(p, h), y)
            return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)
        loss, g = jax.value_and_grad(loss_fn)(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    losses = []
    for _ in range(EPOCHS):
        params, opt_state, loss = step(params, opt_state, feats, ys, ms)
        losses.append(float(loss))
    return losses


def _start_two():
    """The twin as ``torchrun --nproc-per-node 2`` starts it."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "gammagl_tpu_torch.examples.papers100m_trainer", *ARGV],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs):
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    assert "papers100m_sign_epoch" not in logs[1]
    return json.loads([ln for ln in logs[0].splitlines()
                       if "papers100m_sign_epoch" in ln][-1])


def test_sign_recipe_matches_the_jax_twin_at_one_and_two_processes():
    procs = _start_two()
    try:
        one = twin.main(twin.parser().parse_args(ARGV))
        want = _jax_sign(2)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    two = _finish(procs)
    assert (one["parts"], two["parts"]) == (1, 2)
    assert one["metric"] == two["metric"] == "papers100m_sign_epoch"
    for got in (one, two):
        np.testing.assert_allclose(got["losses"][0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert len(one["losses"]) == EPOCHS
    assert want[-1] < 0.2 * want[0]
