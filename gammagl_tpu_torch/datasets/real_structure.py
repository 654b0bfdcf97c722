"""Real citation-graph adjacencies for benches and partition studies
(counterpart of `gammagl_tpu/datasets/real_structure.py`).

The reference repository ships perturbed Cora / Citeseer / PubMed CSR
adjacencies (its examples/citgnn/datasets/<name>_add_<p>.npz: 2708 /
3327 / 19717 nodes, +50% / +75% random edges, no features). Uniform
random graphs flatten degree skew and gather locality; these give real
power-law structure offline. Searched, in order: ``GGL_TPU_REFDATA``,
the repository's ``data/citgnn/``, and ``examples/citgnn/datasets/`` of
a reference checkout named by ``GGL_REFERENCE_ROOT``. Without a copy, a
synthetic power-law graph of the same node count stands in (the JAX
package's draw).
"""

import os
import os.path as osp

import numpy as np

__all__ = ["load_real_structure", "real_structure_available"]

_SIZES = {"cora": 2708, "citeseer": 3327, "pubmed": 19717}


def _search_paths():
    ref = os.environ.get("GGL_REFERENCE_ROOT", "")
    return (os.environ.get("GGL_TPU_REFDATA", ""),
            osp.join(osp.dirname(__file__), "..", "..", "data", "citgnn"),
            osp.join(ref, "examples", "citgnn", "datasets") if ref else "")


def _find(name, perturbation):
    fname = f"{name}_add_{perturbation}.npz"
    for base in _search_paths():
        if base and osp.exists(osp.join(base, fname)):
            return osp.join(base, fname)
    return None


def real_structure_available(name="cora", perturbation="0.5"):
    return _find(name, perturbation) is not None


def load_real_structure(name="cora", perturbation="0.5", seed=0):
    """``(edge_index (2, E) int64, num_nodes, is_real)``; ``is_real`` is
    False when no copy was found and the synthetic stand-in is given."""
    assert name in _SIZES, name
    path = _find(name, perturbation)
    if path is not None:
        import scipy.sparse as sp
        with np.load(path, allow_pickle=True) as f:
            adj = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                                tuple(f["shape"])).tocoo()
        return (np.stack([adj.row, adj.col]).astype(np.int64),
                int(adj.shape[0]), True)
    n = _SIZES[name]
    e = 7 * n
    rng = np.random.default_rng(seed)
    dst = (n * (rng.random(e) ** 1.7)).astype(np.int64)
    src = rng.integers(0, n, e)
    return np.stack([src, dst]), n, False
