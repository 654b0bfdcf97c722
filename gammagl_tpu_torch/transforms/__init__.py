"""Graph transforms (counterpart of `gammagl_tpu/transforms/`; reference:
gammagl/transforms/). Host-side numpy on the port's graphs."""

from gammagl_tpu_torch.transforms.transforms import (
    BaseTransform, Compose, NormalizeFeatures, AddSelfLoops, DropEdge,
    SVDFeatureReduction, SIGN, RandomLinkSplit, AddMetaPaths)

from gammagl_tpu_torch.transforms.vgae_pre import (
    sparse_to_tuple, mask_test_edges, normalize_adj_for_vgae)

__all__ = [
    "BaseTransform",
    "Compose",
    "NormalizeFeatures",
    "AddSelfLoops",
    "DropEdge",
    "SVDFeatureReduction",
    "SIGN",
    "RandomLinkSplit",
    "AddMetaPaths",
    "sparse_to_tuple",
    "mask_test_edges",
    "normalize_adj_for_vgae",
]
