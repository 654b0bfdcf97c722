"""Samplers (counterpart of `gammagl_tpu/sampler/`; reference:
gammagl/sampler/)."""

from gammagl_tpu_torch.sampler.neighbor_sampler import (
    SamplerOutput, NeighborSampler, sample_neighbors_padded)

__all__ = ["SamplerOutput", "NeighborSampler", "sample_neighbors_padded"]
