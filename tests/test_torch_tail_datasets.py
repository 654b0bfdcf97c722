"""The port's last dataset modules (`datasets/wikics.py`, `geom_gcn.py`,
`ppi.py`, `saint_datasets.py`, `wave4_datasets.py`) against the JAX
package's.

The raw files are the JAX package's own fixtures: each case calls the
writer test of `tests/datasets/test_raw_fixtures.py` or
`tests/datasets/test_wave4_datasets.py` on a fresh directory (it writes
the files in the raw layout, from its numpy seed, and builds the JAX
dataset), then builds the port's class on the same root, with
``GGL_TPU_OFFLINE=1`` (nothing is fetched). The port writes its own cache
(``*_torch.pkl``), so it processes the raw files itself; every item must
hold the JAX item's arrays: same keys in the same order, dtypes, shapes
and values.
"""

import os.path as osp
import sys

import numpy as np
import pytest

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.datasets as jds  # noqa: E402
from tests.datasets import test_raw_fixtures as raw  # noqa: E402
from tests.datasets import test_wave4_datasets as wave4  # noqa: E402
from tests.test_torch_typed_datasets import _same  # noqa: E402

import gammagl_tpu_torch.datasets as tds  # noqa: E402


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _same_item(got, want):
    _same(got, want)
    if hasattr(want, "_globals"):  # ACM4DHN's train / val / test graphs
        assert list(got._globals) == list(want._globals)
        for key, sub in want._globals.items():
            _same_item(got._globals[key], sub)


# case -> (the JAX writer test, [(class name, constructor keywords)])
CASES = {
    "wikics": (raw.test_wikics_raw, [("WikiCS", {})]),
    "webkb": (raw.test_webkb_raw, [("WebKB", {"name": "cornell"})]),
    "wikipedia_network": (raw.test_wikipedia_network_raw,
                          [("WikipediaNetwork", {"name": "chameleon"})]),
    "actor": (raw.test_actor_raw, [("Actor", {})]),
    "ppi": (raw.test_ppi_raw, [("PPI", {"split": s})
                               for s in ("train", "val", "test")]),
    "flickr": (lambda p: raw.test_saint_raw(p, "Flickr", False),
               [("Flickr", {})]),
    "yelp": (lambda p: raw.test_saint_raw(p, "Yelp", True), [("Yelp", {})]),
    "modelnet40": (wave4.test_modelnet40,
                   [("ModelNet40", {"split": s, "num_points": 32})
                    for s in ("train", "test")]),
    "shapenet": (wave4.test_shapenet,
                 [("ShapeNet", {"categories": "Airplane", "split": s})
                  for s in ("train", "val", "test", "trainval")]),
    "ngsim": (wave4.test_ngsim, [("NGSIM_US_101", {"name": "train"})]),
    "acm4dhn": (wave4.test_acm4dhn, [("ACM4DHN", {"test_ratio": 0.3})]),
    "acm4rohe": (wave4.test_acm4rohe, [("ACM4Rohe", {})]),
    "addataset": (wave4.test_ad_dataset, [("ADDataset", {"name": "books"})]),
    "alircd": (raw.test_alircd_raw, [("AliRCD", {})]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_matches_jax(case, tmp_path):
    write, builds = CASES[case]
    write(tmp_path)
    root = str(tmp_path)
    for cls, kw in builds:
        want = getattr(jds, cls)(root=root, **kw)
        got = getattr(tds, cls)(root=root, **kw)
        assert type(got).__module__.startswith("gammagl_tpu_torch.")
        assert len(got) == len(want) > 0, (cls, kw)
        for g, w in zip(_items(got), _items(want)):
            _same_item(g, w)


def test_every_jax_dataset_class_is_ported():
    """The port's `datasets` exports each name of the JAX package's."""
    assert set(jds.__all__) <= set(tds.__all__)
    assert set(tds.__all__) == set(jds.__all__)


def test_caches_are_the_ports_own(tmp_path):
    """Each class writes its processed files under names of its own, so
    the JAX package's cache next to it is never read (a pickle carries
    its package's classes)."""
    raw.test_ppi_raw(tmp_path)
    ds = tds.PPI(root=str(tmp_path), split="val")
    names = sorted(osp.basename(p) for p in ds.processed_paths)
    assert names == ["test_torch.pkl", "train_torch.pkl", "val_torch.pkl"]
    jnames = jds.PPI(root=str(tmp_path)).processed_paths
    assert not set(map(osp.basename, jnames)) & set(names)
    wave4.test_shapenet(tmp_path / "sn")
    sn = tds.ShapeNet(root=str(tmp_path / "sn"), categories="Airplane")
    assert all(p.endswith("_torch.pkl") for p in sn.processed_paths)


def test_acm4rohe_split_is_the_seeded_stream(tmp_path):
    """ACM4Rohe's split comes from ``default_rng(seed)``: another seed
    gives another split, each JAX's."""
    wave4.test_acm4rohe(tmp_path)
    masks = {}
    for seed in (0, 3):
        root = tmp_path / f"s{seed}"
        (root / "raw").mkdir(parents=True)
        (root / "raw" / "ACM.mat").write_bytes(
            (tmp_path / "raw" / "ACM.mat").read_bytes())
        got = tds.ACM4Rohe(root=str(root), seed=seed)[0]
        want = jds.ACM4Rohe(root=str(root), seed=seed)[0]
        _same_item(got, want)
        masks[seed] = np.asarray(got["paper"].train_mask)
    assert not np.array_equal(masks[0], masks[3])
