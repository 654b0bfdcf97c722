"""Datasets (counterpart of `gammagl_tpu/datasets/`; reference:
gammagl/datasets/__init__.py).

Ported so far: the synthetic graphs, Planetoid, the OGB node datasets,
TUDataset, the npz datasets and the real-structure loader. Each
`InMemoryDataset` writes its processed cache under its own name
(``data_torch.pkl``), so it never reads the JAX package's.
"""

from gammagl_tpu_torch.datasets.planetoid import Planetoid
from gammagl_tpu_torch.datasets.real_structure import (
    load_real_structure, real_structure_available)
from gammagl_tpu_torch.datasets.npz_datasets import (Amazon, Coauthor,
                                                     FacebookPagePage,
                                                     DeezerEurope, GitHub)
from gammagl_tpu_torch.datasets.tu_dataset import TUDataset
from gammagl_tpu_torch.datasets.synthetic import (
    StochasticBlockModelDataset, synthetic_community_graph)
from gammagl_tpu_torch.datasets.ogb import OgbNodeDataset

__all__ = [
    "Planetoid",
    "load_real_structure",
    "real_structure_available",
    "Amazon",
    "Coauthor",
    "FacebookPagePage",
    "DeezerEurope",
    "GitHub",
    "TUDataset",
    "StochasticBlockModelDataset",
    "synthetic_community_graph",
    "OgbNodeDataset",
]
