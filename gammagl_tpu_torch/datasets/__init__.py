"""Datasets (counterpart of `gammagl_tpu/datasets/`; reference:
gammagl/datasets/__init__.py).

Ported so far: the synthetic graphs, Planetoid, the OGB node datasets,
TUDataset, the npz datasets, the real-structure loader, the typed-graph
datasets (IMDB, DBLP, HGB), the assorted ones (PolBlogs, BlogCatalog,
CA-GrQc, Airports, Entities, ZINC) and wave 3 (ACM4HeCo, Bail, Credit,
AMiner, MoleculeNet, MovieLens, CustomDataset) and Reddit. Each
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
from gammagl_tpu_torch.datasets.hetero_datasets import IMDB, DBLP, HGBDataset
from gammagl_tpu_torch.datasets.misc_datasets import (PolBlogs, BlogCatalog,
                                                      CAGrQc, Airports,
                                                      Entities, ZINC)
from gammagl_tpu_torch.datasets.wave3_datasets import (ACM4HeCo, Bail,
                                                       Credit, AMiner,
                                                       MoleculeNet,
                                                       MovieLens,
                                                       CustomDataset)
from gammagl_tpu_torch.datasets.reddit import Reddit

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
    "IMDB",
    "DBLP",
    "HGBDataset",
    "PolBlogs",
    "BlogCatalog",
    "CAGrQc",
    "CA_GrQc",
    "Airports",
    "Entities",
    "ZINC",
    "ACM4HeCo",
    "Bail",
    "Credit",
    "AMiner",
    "MoleculeNet",
    "MovieLens",
    "CustomDataset",
    "Reddit",
]

# the reference's spelling (gammagl/datasets/__init__.py exports CA_GrQc)
CA_GrQc = CAGrQc
