"""The port's typed-graph and assorted datasets (`datasets/
hetero_datasets.py`, `misc_datasets.py`, `wave3_datasets.py`) against the
JAX package's, and the six hetero twins trained from files.

Every class reads files this module fabricates in the JAX package's raw
layout (the writers of `tests/datasets/test_raw_fixtures.py`, from a
numpy seed), with ``GGL_TPU_OFFLINE=1`` (nothing is fetched); both
packages process one root in turn (each writes its own cache), and every
processed array must equal the JAX package's: same keys in the same
order, dtypes, shapes and values.

Then the hetero twins: hgt, han, hpn, iehgcn and rohehan on a fabricated
IMDB, rgcn on a fabricated Entities ``aifb``, each against the JAX
trainer's model and loop over 3 steps from the JAX init, dropout off,
rtol 1e-5; and the fallback to the synthetic graph when the files are
missing, with the JAX trainers' warning lines, before any folder is made.
"""

import argparse
import gzip
import json
import os
import os.path as osp
import pickle
import sys
import tempfile
import zipfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.datasets as jds  # noqa: E402
from examples.han import han_trainer as jax_han  # noqa: E402
from examples.hgt import hgt_trainer as jax_hgt  # noqa: E402
from examples.hpn import hpn_trainer as jax_hpn  # noqa: E402
from examples.iehgcn import iehgcn_trainer as jax_iehgcn  # noqa: E402
from examples.rgcn import rgcn_trainer as jax_rgcn  # noqa: E402
from examples.rohehan import rohehan_trainer as jax_rohehan  # noqa: E402
from gammagl_tpu.models import HANModel as JaxHANModel  # noqa: E402
from gammagl_tpu.models import RGCNModel as JaxRGCNModel  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_hetero_models import _jax_steps  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402

import gammagl_tpu_torch.datasets as tds  # noqa: E402
from gammagl_tpu_torch.datasets import wave3_datasets  # noqa: E402
from gammagl_tpu_torch.examples import (common, han_trainer,  # noqa
                                        hgt_trainer, hpn_trainer,
                                        iehgcn_trainer, rgcn_trainer,
                                        rohehan_trainer)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_store(got, want, where):
    assert list(got.keys()) == list(want.keys()), (where, list(got.keys()),
                                                   list(want.keys()))
    for k, v in want.items():
        if isinstance(v, (str, int, float)) or v is None:
            assert got[k] == v, (where, k)
            continue
        a, b = _np(got[k]), _np(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}/{k}")


def _same(got, want):
    """Two graphs of the two packages hold the same arrays: a Graph key by
    key, a HeteroGraph type by type."""
    assert type(got).__module__.startswith("gammagl_tpu_torch.")
    assert type(got).__name__ == type(want).__name__
    if hasattr(want, "node_types"):
        assert got.node_types == want.node_types
        assert got.edge_types == want.edge_types
        for t in want.node_types + want.edge_types:
            _same_store(got[t], want[t], t)
            assert got[t].num_nodes == want[t].num_nodes, t
        return
    assert got.num_nodes == want.num_nodes
    _same_store(got, want, type(want).__name__)


# -- writers: the raw layouts of tests/datasets/test_raw_fixtures.py -------

def _block_adj(sizes, blocks):
    n = sum(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    adj = np.zeros((n, n), np.float32)
    for (i, j), m in blocks.items():
        adj[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = m
    return sp.csr_matrix(adj)


def write_imdb(root, seed=0, sizes=(40, 15, 50), f=12, c=3, n_actors=3):
    """IMDB's processed-zip layout: movie | director | actor features (CSR
    npz), labels.npy, the split npz and the block adjacency adjM.npz
    (each movie one director and ``n_actors`` actors, both directions).
    More actors than movies, as in the release (5,257 against 4,278)."""
    rng = np.random.default_rng(seed)
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    n_m, n_d, n_a = sizes
    y = rng.integers(0, c, n_m)
    for i, sz in enumerate(sizes):
        x = (rng.random((sz, f)) < 0.3).astype(np.float32)
        if i == 0:
            x[np.arange(n_m), y] = 1.0  # a class signal
        sp.save_npz(osp.join(raw, f"features_{i}.npz"), sp.csr_matrix(x))
    np.save(osp.join(raw, "labels.npy"), y)
    perm = rng.permutation(n_m)
    np.savez(osp.join(raw, "train_val_test_idx.npz"),
             train_idx=np.sort(perm[:n_m // 2]),
             val_idx=np.sort(perm[n_m // 2:3 * n_m // 4]),
             test_idx=np.sort(perm[3 * n_m // 4:]))
    md = np.zeros((n_m, n_d), np.float32)
    md[np.arange(n_m), (n_d // c) * y + rng.integers(0, n_d // c, n_m)] = 1
    ma = np.zeros((n_m, n_a), np.float32)
    for m in range(n_m):
        ma[m, rng.choice(n_a, n_actors, replace=False)] = 1
    sp.save_npz(osp.join(raw, "adjM.npz"), _block_adj(
        sizes, {(0, 1): md, (1, 0): md.T, (0, 2): ma, (2, 0): ma.T}))
    return {}


def write_dblp(root, seed=1):
    rng = np.random.default_rng(seed)
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    sizes = [4, 5, 3, 2]  # author, paper, term, conference (no features)
    for i, sz in enumerate(sizes[:3]):
        sp.save_npz(osp.join(raw, f"features_{i}.npz"), sp.csr_matrix(
            rng.random((sz, 4)).astype(np.float32)))
    np.save(osp.join(raw, "labels.npy"), rng.integers(0, 4, sizes[0]))
    np.savez(osp.join(raw, "train_val_test_idx.npz"),
             train_idx=np.asarray([0]), val_idx=np.asarray([1]),
             test_idx=np.asarray([2, 3]))
    ap = (rng.random((4, 5)) < 0.5).astype(np.float32)
    pc = (rng.random((5, 2)) < 0.5).astype(np.float32)
    sp.save_npz(osp.join(raw, "adjM.npz"), _block_adj(
        sizes, {(0, 1): ap, (1, 0): ap.T, (1, 3): pc, (3, 1): pc.T}))
    return {}


def write_hgb(root):
    raw = osp.join(root, "acm", "raw")
    os.makedirs(raw, exist_ok=True)
    info = {"node.dat": {"node type": {"0": ["paper"], "1": ["author"]}},
            "link.dat": {"link type": {
                "0": {"start": 0, "end": 1, "meaning": "writes"}}}}
    with open(osp.join(raw, "info.dat"), "w") as fh:
        fh.write(json.dumps(info))
    lines = [f"{i}\tp{i}\t0\t0.1,0.2,0.{i}" for i in range(4)]
    lines += [f"{i}\ta{i}\t1" for i in range(4, 7)]
    with open(osp.join(raw, "node.dat"), "w") as fh:
        fh.write("\n".join(lines))
    with open(osp.join(raw, "link.dat"), "w") as fh:
        fh.write("\n".join(f"{i}\t{4 + i % 3}\t0\t1.0" for i in range(4)))
    with open(osp.join(raw, "label.dat"), "w") as fh:
        fh.write("0\tp0\t0\t2\n1\tp1\t0\t1\n")
    with open(osp.join(raw, "label.dat.test"), "w") as fh:
        fh.write("2\tp2\t0\t0\n")
    return {"name": "acm"}


def write_polblogs(root):
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    with open(osp.join(raw, "adjacency.tsv"), "w") as fh:
        for a, b in rng.integers(0, 8, (20, 2)):
            fh.write(f"{a}\t{b}\t1\n")
    with open(osp.join(raw, "labels.tsv"), "w") as fh:
        fh.write("\n".join(str(int(v)) for v in rng.integers(0, 2, 8)))
    return {}


def write_blogcatalog(root):
    rng = np.random.default_rng(0)
    raw = osp.join(root, "raw")
    inner = osp.join(root, "payload", "blogcatalog")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(inner, exist_ok=True)
    n = 9
    sp.save_npz(osp.join(inner, "adj.npz"), sp.csr_matrix(
        (rng.random((n, n)) < 0.3).astype(np.float32)))
    np.savez(osp.join(inner, "attr.npz"), rng.random((n, 6)).astype(
        np.float32))
    np.save(osp.join(inner, "label.npy"), rng.integers(0, 3, n))
    with zipfile.ZipFile(osp.join(raw, "blogcatalog.zip"), "w") as z:
        for f in sorted(os.listdir(inner)):
            z.write(osp.join(inner, f), arcname=f"blogcatalog/{f}")
    return {}


def write_ca_grqc(root):
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    with open(osp.join(raw, "ca-GrQc.txt"), "w") as fh:
        fh.write("# comment line\n# another\n")
        for a, b in [(100, 200), (200, 300), (300, 100), (400, 200)]:
            fh.write(f"{a}\t{b}\n")
    return {}


def write_airports(root):
    raw = osp.join(root, "usa", "raw")
    os.makedirs(raw, exist_ok=True)
    with open(osp.join(raw, "labels-usa-airports.txt"), "w") as fh:
        fh.write("node label\n17 0\n42 1\n99 1\n7 0\n")
    with open(osp.join(raw, "usa-airports.edgelist"), "w") as fh:
        fh.write("17 42\n42 99\n99 7\n")
    return {"name": "usa"}


def write_entities(root, seed=0, n_people=30, n_affs=3):
    """An ``aifb`` release: N-Triples of people who are members of an
    affiliation, know other people and work with them, and the train /
    test TSVs of the people's affiliations (aifb's column names)."""
    rng = np.random.default_rng(seed)
    raw = osp.join(root, "aifb", "raw")
    os.makedirs(raw, exist_ok=True)
    people = [f"http://ex.org/person{i}" for i in range(n_people)]
    affs = [f"http://ex.org/aff{i}" for i in range(n_affs)]
    aff_of = rng.integers(0, n_affs, n_people)
    lines = []
    for i, p in enumerate(people):
        lines.append(f"<{p}> <http://ex.org/member> <{affs[aff_of[i]]}> .")
        for j in rng.choice(n_people, 2, replace=False):
            lines.append(f"<{p}> <http://ex.org/knows> <{people[j]}> .")
        same = np.nonzero(aff_of == aff_of[i])[0]
        lines.append(f"<{p}> <http://ex.org/worksWith> "
                     f"<{people[rng.choice(same)]}> .")
    with gzip.open(osp.join(raw, "aifb_stripped.nt.gz"), "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    header = "id\tperson\tlabel_affiliation\n"
    order = rng.permutation(n_people)
    for fname, ids in (("trainingSet.tsv", order[:n_people // 2]),
                       ("testSet.tsv", order[n_people // 2:])):
        with open(osp.join(raw, fname), "w") as fh:
            fh.write(header)
            for i in ids:
                fh.write(f"{i}\t{people[i]}\t{affs[aff_of[i]]}\n")
    with open(osp.join(raw, "completeDataset.tsv"), "w") as fh:
        fh.write(header)
    return {"name": "aifb"}


def write_zinc(root):
    raw = osp.join(root, "raw", "molecules")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        mols = []
        for _ in range(3):
            n = int(rng.integers(3, 6))
            bond = np.triu(rng.integers(0, 3, (n, n)), 1)
            mols.append({"atom_type": rng.integers(0, 20, n),
                         "bond_type": bond + bond.T,
                         "logP_SA_cycle_normalized": float(rng.random())})
        with open(osp.join(raw, f"{split}.pickle"), "wb") as fh:
            pickle.dump(mols, fh)
    return {}


def write_acm4heco(root):
    rng = np.random.default_rng(0)
    raw = osp.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    n_p, n_a, n_s = 8, 5, 3
    sp.save_npz(osp.join(raw, "p_feat.npz"), sp.csr_matrix(
        rng.random((n_p, 6)).astype(np.float32)))
    np.save(osp.join(raw, "labels.npy"), rng.integers(0, 3, n_p))
    np.savetxt(osp.join(raw, "pa.txt"), np.stack(
        [rng.integers(0, n_p, 12), rng.integers(0, n_a, 12)], 1), fmt="%d")
    np.savetxt(osp.join(raw, "ps.txt"), np.stack(
        [np.arange(n_p), rng.integers(0, n_s, n_p)], 1), fmt="%d")
    for ratio in (20, 40, 60):
        for split in ("train", "val", "test"):
            np.save(osp.join(raw, f"{split}_{ratio}.npy"),
                    rng.permutation(n_p)[:3])
    return {}


def write_fairness(root, name, parts):
    raw = osp.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    for p in parts:
        n = 6
        feats = rng.random((n, 4))
        feats[:, -1] = rng.integers(0, 2, n)
        header = ",".join(f"f{i}" for i in range(4))
        np.savetxt(osp.join(raw, f"{name}{p}.csv"), feats, delimiter=",",
                   header=header, comments="")
        np.savetxt(osp.join(raw, f"{name}{p}_edges.txt"),
                   rng.integers(0, n, (10, 2)), fmt="%d")
    return {}


def write_aminer(root):
    rng = np.random.default_rng(0)
    raw = osp.join(root, "raw")
    os.makedirs(osp.join(raw, "label"), exist_ok=True)
    np.savetxt(osp.join(raw, "paper_author.txt"), np.stack(
        [rng.integers(0, 7, 15), rng.integers(0, 4, 15)], 1), fmt="%d")
    np.savetxt(osp.join(raw, "paper_conf.txt"), np.stack(
        [np.arange(7), rng.integers(0, 2, 7)], 1), fmt="%d")
    for f in ("id_author.txt", "id_conf.txt", "paper.txt"):
        open(osp.join(raw, f), "w").close()
    return {}


def write_moleculenet(root):
    raw = osp.join(root, "esol", "raw")
    os.makedirs(raw, exist_ok=True)
    with open(osp.join(raw, "delaney-processed.csv"), "w") as fh:
        fh.write("smiles,measured log solubility in mols per litre\n")
        fh.write("CCO,-0.5\nC1CC1,1.25\nbadrow,not_a_float\n")
    return {"name": "esol"}


def write_movielens(root):
    raw = osp.join(root, "raw", "ml-100k")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = np.stack([rng.integers(1, 6, 20), rng.integers(1, 9, 20),
                     rng.integers(1, 6, 20), rng.integers(0, 10**9, 20)], 1)
    np.savetxt(osp.join(raw, "u.data"), rows, fmt="%d", delimiter="\t")
    for f in ("u.item", "u.user"):
        open(osp.join(raw, f), "w").close()
    return {}


DATASETS = {
    "IMDB": write_imdb, "DBLP": write_dblp, "HGBDataset": write_hgb,
    "PolBlogs": write_polblogs, "BlogCatalog": write_blogcatalog,
    "CAGrQc": write_ca_grqc, "Airports": write_airports,
    "Entities": write_entities, "ZINC": write_zinc,
    "ACM4HeCo": write_acm4heco,
    "Bail": lambda root: write_fairness(root, "bail", jds.Bail.parts),
    "Credit": lambda root: write_fairness(root, "credit", jds.Credit.parts),
    "AMiner": write_aminer, "MoleculeNet": write_moleculenet,
    "MovieLens": write_movielens,
}


def _fake_from_smiles(graph_cls):
    def from_smiles(s):
        n = len(s)
        return graph_cls(x=np.zeros((n, 9), np.int64),
                         edge_index=np.stack([np.arange(n - 1),
                                              np.arange(1, n)]).astype(
                             np.int64))
    return from_smiles


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_matches_jax(name, tmp_path, monkeypatch):
    """The same raw files give the JAX package's arrays, item by item;
    ZINC in each of its three splits; MoleculeNet with rdkit's parse
    replaced in both packages by one fake (neither machine has rdkit),
    its unparsable target row dropped by both."""
    root = str(tmp_path)
    kw = DATASETS[name](root)
    if name == "MoleculeNet":
        import gammagl_tpu.utils.smiles as jsmiles
        from gammagl_tpu.data.graph import Graph as JGraph
        from gammagl_tpu_torch.data import Graph as TGraph
        monkeypatch.setattr(jsmiles, "from_smiles", _fake_from_smiles(JGraph))
        monkeypatch.setattr(wave3_datasets, "_from_smiles",
                            _fake_from_smiles(TGraph))
    splits = ({"split": s} for s in ("train", "val", "test")) \
        if name == "ZINC" else [{}]
    for extra in splits:
        want = getattr(jds, name)(root=root, **kw, **extra)
        got = getattr(tds, name)(root=root, **kw, **extra)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            _same(got[i], want[i])
        # a second construction reads the port's own cache
        again = getattr(tds, name)(root=root, **kw, **extra)
        _same(again[0], want[0])
    assert tds.CA_GrQc is tds.CAGrQc


def test_custom_dataset_matches_jax(tmp_path):
    from gammagl_tpu.data.graph import Graph as JGraph
    from gammagl_tpu_torch.data import Graph as TGraph

    def graphs(cls):
        return [cls(x=np.full((4, 2), i, np.float32),
                    edge_index=np.asarray([[0, 1], [1, 2]]),
                    y=np.asarray([i])) for i in range(3)]
    want = jds.CustomDataset(graphs(JGraph), root=str(tmp_path / "j"))
    got = tds.CustomDataset(graphs(TGraph), root=str(tmp_path / "t"))
    assert len(got) == len(want) == 3
    for i in range(3):
        _same(got[i], want[i])
    default = tds.CustomDataset(graphs(TGraph))
    assert osp.dirname(default.root) == tempfile.gettempdir()


def test_entities_parser_is_the_fallback_without_rdflib(tmp_path):
    """Neither machine has rdflib: both packages take the minimal
    N-Triples parser, which keeps each term's spelling (<uri> with its
    brackets) and skips comments and blank lines."""
    with pytest.raises(ImportError):
        import rdflib  # noqa: F401
    lines = ["# a comment", "", "<a> <p> <b> .", '<b> <q> "lit" .']
    got = tds.Entities._parse_nt(iter(lines))
    assert got == jds.Entities._parse_nt(iter(lines))
    assert got == [("<a>", "<p>", "<b>"), ("<b>", "<q>", '"lit"')]


# -- the hetero twins from files ----------------------------------------------

IMDB_TWINS = {"hgt": (hgt_trainer, jax_hgt), "hpn": (hpn_trainer, jax_hpn),
              "iehgcn": (iehgcn_trainer, jax_iehgcn),
              "rohehan": (rohehan_trainer, jax_rohehan),
              "han": (han_trainer, jax_han)}


def _no_hgt_dropout(module, monkeypatch):
    """The hgt twin's model with its HGTConvs' attention dropout off (the
    JAX loop below runs with ``train=False``): masks cannot be matched
    across the packages."""
    make = module.HGTModel

    def model(*args, **kwargs):
        m = make(*args, **kwargs)
        for conv in m.convs:
            conv.dropout_rate = 0.0
        return m
    monkeypatch.setattr(module, "HGTModel", model)


@pytest.mark.parametrize("name", sorted(IMDB_TWINS))
def test_imdb_twin_matches_the_jax_trainer(name, tmp_path, monkeypatch):
    """The twin reads IMDB from ``--dataset_path`` as the JAX trainer's
    loader does, builds the JAX trainer's model (captured from its
    ``main``; HAN's from its script) and 3 of its steps from the JAX
    init give the JAX losses."""
    write_imdb(str(tmp_path))
    module, jmod = IMDB_TWINS[name]
    targs = module.parser().parse_args(
        ["--device", "cpu", "--n_epoch", "3", "--dataset_path",
         str(tmp_path)] + (["--drop_rate", "0"] if name == "han" else []))
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items()
                                  if k != "device"})
    if name == "han":
        jhg, target = jax_han.load(jargs)
        jhg = jhg.tensor()
        jm = JaxHANModel(jhg.metadata(), jargs.hidden_dim,
                         int(np.asarray(jhg[target].y).max()) + 1, target,
                         heads=jargs.heads, drop_rate=0.0)
    else:
        monkeypatch.setattr(jmod, "run_hetero_trainer",
                            lambda make, args, dataset_loader: (
                                make, dataset_loader))
        make, loader = jmod.main(jargs)
        jhg, target = loader(jargs)
        jhg = jhg.tensor()
        jm = make(jhg.metadata(), int(np.asarray(jhg[target].y).max()) + 1,
                  target)
    if name == "hgt":
        _no_hgt_dropout(hgt_trainer, monkeypatch)
    key = jax.random.PRNGKey(targs.seed)
    params = jm.init({"params": key, "dropout": key}, jhg.x_dict,
                     jhg.edge_index_dict)
    y = jnp.asarray(np.asarray(jhg[target].y))
    mask = jnp.asarray(np.asarray(jhg[target].train_mask))
    want = _jax_steps(lambda p: jax_loss(jm.apply(p, jhg.x_dict,
                                              jhg.edge_index_dict), y, mask),
                  params, targs.lr, 3)
    got = module.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def test_rgcn_twin_on_entities_c24(tmp_path, capsys):
    """ROADMAP C24: the JAX rgcn trainer reads ``g.y`` and the masks of
    an Entities graph, which holds labelled splits instead, and stops;
    the port's twin turns the splits into labels and masks
    (`entities_data`). Its 3 steps equal the JAX model and loop on those
    arrays, built here from the JAX package's Entities graph."""
    write_entities(str(tmp_path))
    targs = rgcn_trainer.parser().parse_args(
        ["--device", "cpu", "--n_epoch", "3", "--dataset_path",
         str(tmp_path)])
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items()
                                  if k != "device"})
    with pytest.raises(AttributeError, match="y"):
        jax_rgcn.main(jargs)
    g, num_rel = jax_rgcn.load(jargs)
    n = g.num_nodes
    y = np.zeros(n, np.int64)
    masks = {}
    for split in ("train", "test"):
        idx = np.asarray(g[f"{split}_idx"])
        y[idx] = np.asarray(g[f"{split}_y"])
        masks[split] = np.isin(np.arange(n), idx)
    model = JaxRGCNModel(targs.feat_dim, targs.hidden_dim,
                         int(y.max()) + 1, num_rel,
                         num_bases=targs.num_bases)
    x = jnp.eye(n, targs.feat_dim, dtype=jnp.float32)
    ei = jnp.asarray(np.asarray(g.edge_index))
    et = jnp.asarray(np.asarray(g.edge_type))
    params = model.init(jax.random.PRNGKey(targs.seed), x, ei, et)
    want = _jax_steps(lambda p: jax_loss(model.apply(p, x, ei, et),
                                     jnp.asarray(y),
                                     jnp.asarray(masks["train"])),
                  params, targs.lr, 3)
    capsys.readouterr()
    got = rgcn_trainer.main(targs, params=_np_tree(params))
    assert "[warn]" not in capsys.readouterr().out
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("name,line", [
    ("hgt", "[warn] dataset unavailable"), ("hpn", "[warn] dataset "
                                            "unavailable"),
    ("iehgcn", "[warn] dataset unavailable"),
    ("rohehan", "[warn] dataset unavailable"),
    ("han", "[warn] IMDB unavailable"), ("rgcn", "[warn] entities "
                                         "unavailable")])
def test_twin_falls_back_without_files(name, line, tmp_path, capsys):
    """No files under ``--dataset_path``: the twin prints the JAX
    trainer's warning line and trains on the synthetic graph, having made
    no folder there (it never fetches); a ``data=`` argument overrides
    the loader."""
    module = {**{k: v[0] for k, v in IMDB_TWINS.items()},
              "rgcn": rgcn_trainer}[name]
    path = tmp_path / "none"
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch", "2",
                                       "--dataset_path", str(path)])
    out = module.main(args)
    assert line in capsys.readouterr().out
    assert not path.exists()
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    data = (rgcn_trainer.synthetic_kg() if name == "rgcn"
            else common.synthetic_hetero())
    again = module.main(args, data=data)
    assert "[warn]" not in capsys.readouterr().out
    np.testing.assert_allclose(again["losses"], out["losses"], rtol=1e-6)
