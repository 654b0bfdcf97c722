"""Process groups: the counterpart of `gammagl_tpu/parallel/mesh.py`.

The JAX package lays devices out in a `Mesh` and shards arrays over its
axes. The port runs one process per part instead, joined by
``torch.distributed``; a process owns one node block of a partition, and
the collectives of the halo tiers run over its group. Nothing here starts
a group: the caller calls ``torch.distributed.init_process_group`` with its
own address (``tcp://...`` or ``file://...``), world size and rank.
"""

import torch.distributed as dist

__all__ = ["world", "part_world"]


def world(group=None):
    """``(rank, world_size, group)`` of this process: of ``group`` or of
    the default group when one is initialised, else ``(0, 1, None)``."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise RuntimeError("a process group was given, but "
                               "torch.distributed is not initialised")
        return 0, 1, None
    return dist.get_rank(group), dist.get_world_size(group), group


def part_world(num_parts, group=None):
    """``(rank, num_parts, group)`` for a partition of ``num_parts`` parts.

    One part needs no group: ``(0, 1, None)``, with no collective. More
    parts need an initialised group of exactly that size (this process
    owns the part of its rank); anything else raises, so a partition is
    never quietly run one part of several.
    """
    if num_parts == 1:
        return 0, 1, None
    rank, size, group = world(group)
    if size != num_parts:
        raise RuntimeError(
            f"the partition has {num_parts} parts, but the process group "
            f"has {size} process(es): initialise torch.distributed with "
            f"world size {num_parts}")
    return rank, num_parts, group
