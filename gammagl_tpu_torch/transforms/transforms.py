"""Transform implementations (counterpart of
`gammagl_tpu/transforms/transforms.py`).

Reference semantics per file in gammagl/transforms/: base_transform.py:1,
compose.py, normalize_features.py, drop_edge.py, svd_feature_reduction.py,
sign.py:7 (SIGN precompute), random_link_split.py:14, add_metapaths.py:9.
All host-side (numpy) preprocessing on the port's `Graph` and
`HeteroGraph`; the seeded draws are the JAX package's numpy stream.
"""

import numpy as np

from gammagl_tpu_torch.utils.loop import add_self_loops as _add_self_loops

__all__ = [
    "BaseTransform", "Compose", "NormalizeFeatures", "AddSelfLoops",
    "DropEdge", "SVDFeatureReduction", "SIGN", "RandomLinkSplit",
    "AddMetaPaths",
]


class BaseTransform:
    def __call__(self, data):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class Compose(BaseTransform):
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class NormalizeFeatures(BaseTransform):
    """Row-normalize the given attributes (reference normalize_features.py)."""

    def __init__(self, attrs=("x",)):
        self.attrs = attrs

    def __call__(self, data):
        for key in self.attrs:
            if key in data:
                v = np.asarray(data[key], np.float32)
                v = v - v.min() if v.min() < 0 else v
                s = v.sum(axis=-1, keepdims=True)
                data[key] = v / np.maximum(s, 1e-12)
        return data


class AddSelfLoops(BaseTransform):
    def __init__(self, fill_value=1.0):
        self.fill_value = fill_value

    def __call__(self, data):
        ei, ea = _add_self_loops(np.asarray(data.edge_index),
                                 data._store.get("edge_attr"),
                                 fill_value=self.fill_value,
                                 num_nodes=data.num_nodes)
        data.edge_index = ei
        if ea is not None:
            data.edge_attr = ea
        return data


class DropEdge(BaseTransform):
    """Randomly drop edges (reference drop_edge.py)."""

    def __init__(self, p=0.5, seed=None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        ei = np.asarray(data.edge_index)
        keep = self.rng.random(ei.shape[1]) >= self.p
        data.edge_index = ei[:, keep]
        if "edge_attr" in data:
            data.edge_attr = np.asarray(data.edge_attr)[keep]
        return data


class SVDFeatureReduction(BaseTransform):
    def __init__(self, out_channels):
        self.out_channels = out_channels

    def __call__(self, data):
        x = np.asarray(data.x, np.float32)
        if x.shape[-1] > self.out_channels:
            u, s, _ = np.linalg.svd(x, full_matrices=False)
            data.x = u[:, :self.out_channels] * s[:self.out_channels]
        return data


class SIGN(BaseTransform):
    """Precompute K powers of the normalized adjacency applied to x
    (reference sign.py:7): adds x1..xK attributes."""

    def __init__(self, K):
        self.K = K

    def __call__(self, data):
        ei = np.asarray(data.edge_index)
        n = data.num_nodes
        deg = np.bincount(ei[1], minlength=n).astype(np.float32)
        dis = np.where(deg > 0, np.where(deg > 0, deg, 1.0) ** -0.5, 0.0)
        w = dis[ei[0]] * dis[ei[1]]
        x = np.asarray(data.x, np.float32)
        for k in range(1, self.K + 1):
            nxt = np.zeros_like(x)
            np.add.at(nxt, ei[1], x[ei[0]] * w[:, None])
            data[f"x{k}"] = nxt
            x = nxt
        return data


class RandomLinkSplit(BaseTransform):
    """Split edges into train/val/test message+supervision sets
    (reference random_link_split.py:14). Returns (train, val, test) graphs
    each with edge_label_index / edge_label."""

    def __init__(self, num_val=0.1, num_test=0.2, is_undirected=False,
                 add_negative_train_samples=True, neg_sampling_ratio=1.0,
                 seed=None):
        self.num_val = num_val
        self.num_test = num_test
        self.is_undirected = is_undirected
        self.add_negative_train_samples = add_negative_train_samples
        self.neg_sampling_ratio = neg_sampling_ratio
        self.rng = np.random.default_rng(seed)

    def _neg(self, ei, num_nodes, k):
        from gammagl_tpu_torch.utils.negative_sampling import (
            negative_sampling)
        return negative_sampling(ei, num_nodes=num_nodes,
                                 num_neg_samples=k, rng=self.rng)

    def __call__(self, data):
        ei = np.asarray(data.edge_index)
        E = ei.shape[1]
        if self.is_undirected:
            mask = ei[0] <= ei[1]
            ei_u = ei[:, mask]
            E = ei_u.shape[1]
        else:
            ei_u = ei
        perm = self.rng.permutation(E)
        n_val = int(self.num_val * E) if self.num_val < 1 else int(
            self.num_val)
        n_test = int(self.num_test * E) if self.num_test < 1 else int(
            self.num_test)
        val_e = ei_u[:, perm[:n_val]]
        test_e = ei_u[:, perm[n_val:n_val + n_test]]
        train_e = ei_u[:, perm[n_val + n_test:]]

        def undo(e):
            return (np.concatenate([e, e[::-1]], axis=1)
                    if self.is_undirected else e)

        def build(msg_edges, sup_edges, with_neg):
            g = data.clone()
            g.edge_index = undo(msg_edges)
            label_idx = sup_edges
            label = np.ones(sup_edges.shape[1])
            if with_neg:
                k = int(sup_edges.shape[1] * self.neg_sampling_ratio)
                neg = self._neg(ei, data.num_nodes, k)
                label_idx = np.concatenate([label_idx, neg], axis=1)
                label = np.concatenate([label, np.zeros(k)])
            g.edge_label_index = label_idx
            g.edge_label = label
            return g

        train = build(train_e, train_e, self.add_negative_train_samples)
        val = build(train_e, val_e, True)
        test = build(np.concatenate([train_e, val_e], axis=1), test_e, True)
        return train, val, test


class AddMetaPaths(BaseTransform):
    """Add composed metapath edge types to a HeteroGraph
    (reference add_metapaths.py:9)."""

    def __init__(self, metapaths, drop_orig_edge_types=False):
        self.metapaths = metapaths
        self.drop_orig = drop_orig_edge_types

    def __call__(self, data):
        import scipy.sparse as sp
        for path in self.metapaths:
            assert len(path) >= 2
            mats = []
            for et in path:
                src_t, _, dst_t = et if len(et) == 3 else (
                    et[0], "to", et[1])
                key = et if len(et) == 3 else (et[0], "to", et[1])
                ei = np.asarray(data[key].edge_index)
                n_src = data[src_t].num_nodes or int(ei[0].max()) + 1
                n_dst = data[dst_t].num_nodes or int(ei[1].max()) + 1
                mats.append(sp.coo_matrix(
                    (np.ones(ei.shape[1]), (ei[0], ei[1])),
                    shape=(n_src, n_dst)).tocsr())
            prod = mats[0]
            for m in mats[1:]:
                prod = prod @ m
            prod = prod.tocoo()
            first = path[0] if len(path[0]) == 3 else (path[0][0], "to",
                                                       path[0][1])
            last = path[-1] if len(path[-1]) == 3 else (path[-1][0], "to",
                                                        path[-1][1])
            new_type = (first[0], "metapath_" + "_".join(
                p[1] if len(p) == 3 else "to" for p in path), last[2])
            data[new_type].edge_index = np.stack([prod.row, prod.col]
                                                 ).astype(np.int64)
        if self.drop_orig:
            for path in self.metapaths:
                for et in path:
                    key = et if len(et) == 3 else (et[0], "to", et[1])
                    if key in data._edge_stores:
                        del data._edge_stores[key]
        return data
