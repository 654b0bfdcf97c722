"""Graph data structures and the dataset lifecycle (counterpart of
`gammagl_tpu/data/`)."""

from gammagl_tpu_torch.data.graph import Graph, BaseGraph
from gammagl_tpu_torch.data.heterograph import HeteroGraph
from gammagl_tpu_torch.data.batch import BatchGraph
from gammagl_tpu_torch.data.dataset import Dataset, InMemoryDataset
from gammagl_tpu_torch.data.padding import pad_graph, size_bucket, pad_to
from gammagl_tpu_torch.data.download import (download_url, extract_zip,
                                             extract_tar, extract_gz)
from gammagl_tpu_torch.data.feature_store import (TensorAttr, FeatureStore,
                                                  InMemoryFeatureStore)
from gammagl_tpu_torch.data.graph_store import (EdgeLayout, EdgeAttr,
                                                GraphStore,
                                                InMemoryGraphStore)
from gammagl_tpu_torch.data.config import get_config, get_dataset_root
from gammagl_tpu_torch.data.edge_index import EdgeIndex

__all__ = [
    "Graph",
    "BaseGraph",
    "HeteroGraph",
    "BatchGraph",
    "Dataset",
    "InMemoryDataset",
    "pad_graph",
    "size_bucket",
    "pad_to",
    "download_url",
    "extract_zip",
    "extract_tar",
    "extract_gz",
    "TensorAttr",
    "FeatureStore",
    "InMemoryFeatureStore",
    "EdgeLayout",
    "EdgeAttr",
    "GraphStore",
    "InMemoryGraphStore",
    "get_config",
    "get_dataset_root",
    "EdgeIndex",
]
