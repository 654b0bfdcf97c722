"""Process groups: the counterpart of `gammagl_tpu/parallel/mesh.py`.

The JAX package lays devices out in a `Mesh` and shards arrays over its
axes. The port runs one process per part instead, joined by
``torch.distributed``; a process owns one node block of a partition, and
the collectives of the halo tiers run over its group. Nothing here starts
a group: the caller calls ``torch.distributed.init_process_group`` with its
own address (``tcp://...`` or ``file://...``), world size and rank.

The JAX package's two-level mesh ``('slice', 'dp')`` is `hier_world`: the
world cut into S slices of D processes, slice-major (rank r is slice
``r // D``, dp index ``r % D``, as the JAX mesh lays out its devices),
with one group along each axis.
"""

from typing import NamedTuple

import torch.distributed as dist

__all__ = ["world", "part_world", "HierGrid", "hier_world"]


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


class HierGrid(NamedTuple):
    """This process's place in an S x D grid and the groups of its axes.

    ``dp`` holds the D processes of its slice, ``slice`` the S processes
    that share its dp index; an axis of one process has no group (None)
    and runs no collective. ``group`` is the whole grid's group (None: the
    default group), over which the recipes sum losses and gradients."""
    s: int
    d: int
    dp: object
    slice: object
    group: object
    num_slices: int
    dp_per_slice: int

    @property
    def rank(self):
        return self.s * self.dp_per_slice + self.d


def hier_world(num_slices, dp_per_slice, group=None):
    """The `HierGrid` of this process in a ``(num_slices, dp_per_slice)``
    grid over ``group`` (None: the default group).

    The (1, 1) grid needs no group. Any other needs an initialised group
    of exactly S*D processes, or this raises, as `part_world` does.
    ``torch.distributed.new_group`` is collective over the whole default
    group, so every process of the job calls this with the same grid: it
    creates the S dp groups, then the D slice groups, in that order.
    """
    S, D = int(num_slices), int(dp_per_slice)
    if S < 1 or D < 1:
        raise ValueError(f"a grid of {S} x {D} processes")
    if isinstance(group, HierGrid):
        if (group.num_slices, group.dp_per_slice) != (S, D):
            raise ValueError(f"the grid given is {group.num_slices} x "
                             f"{group.dp_per_slice}, the partition "
                             f"{S} x {D}")
        return group
    rank, size, group = part_world(S * D, group)
    if S * D == 1:
        return HierGrid(0, 0, None, None, None, 1, 1)
    glob = [i if group is None else dist.get_global_rank(group, i)
            for i in range(size)]
    dp_group = slice_group = None
    if D > 1:
        for s in range(S):
            g = dist.new_group([glob[s * D + d] for d in range(D)])
            if s == rank // D:
                dp_group = g
    if S > 1:
        for d in range(D):
            g = dist.new_group([glob[s * D + d] for s in range(S)])
            if d == rank % D:
                slice_group = g
    return HierGrid(rank // D, rank % D, dp_group, slice_group, group, S, D)
