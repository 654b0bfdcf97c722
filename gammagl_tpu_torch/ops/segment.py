"""Segment reductions: the scatter-aggregate primitive of message passing.

PyTorch counterpart of `gammagl_tpu/ops/segment.py`. The padding
convention is the same: a row whose segment id is out of range (for
example the padding id ``num_segments``) is dropped, so padded edges are
exact no-ops in every reduction, and an empty segment gives 0.

Out-of-range rows are sent to one extra segment that is cut off at the
end, so no reduction waits on the device to learn a data-dependent size.
Counts are taken in float32 whatever the dtype asked for, so a bfloat16
degree does not saturate at 256 as it would when summed in bfloat16.
"""

from math import inf

import torch

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_max",
           "segment_min", "unsorted_segment_sum", "unsorted_segment_mean",
           "unsorted_segment_max", "unsorted_segment_min"]


def _ids(segment_ids, num_segments, data=None):
    """Segment ids as int64, with every out-of-range id replaced by the
    spill segment ``num_segments``."""
    if segment_ids.dim() != 1:
        raise ValueError("segment_ids must be 1-D, got shape "
                         f"{tuple(segment_ids.shape)}")
    if data is not None and segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"segment_ids length {segment_ids.shape[0]} != data leading dim "
            f"{data.shape[0]}")
    ids = segment_ids.long()
    return ids.masked_fill((ids < 0) | (ids >= num_segments), num_segments)


def _zeros(data, num_segments):
    """Output with the spill segment as its last row."""
    return data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))


def segment_sum(data, segment_ids, num_segments):
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``.

    Out-of-range ids are dropped. The result has ``data``'s dtype.
    """
    ids = _ids(segment_ids, num_segments, data)
    return _zeros(data, num_segments).index_add_(0, ids, data)[:num_segments]


def segment_count(segment_ids, num_segments, dtype=torch.float32):
    """Number of entries per segment (in-degree when ids are edge dsts)."""
    ids = _ids(segment_ids, num_segments)
    ones = torch.ones(ids.shape[0], device=ids.device)
    count = torch.zeros(num_segments + 1, device=ids.device)
    return count.index_add_(0, ids, ones)[:num_segments].to(dtype)


def segment_mean(data, segment_ids, num_segments):
    """Mean of ``data`` rows per segment; empty segments give 0. Floating
    data keeps its dtype; integer data gives float32 (true division), as
    in the JAX package."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments).clamp_min(1)
    count = count.reshape((num_segments,) + (1,) * (data.dim() - 1))
    mean = total / count
    return mean.to(data.dtype) if data.is_floating_point() else mean


def _segment_extreme(data, segment_ids, num_segments, reduce):
    ids = _ids(segment_ids, num_segments, data)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    if not data.is_floating_point():
        # include_self=False: a segment with rows takes their max/min
        # alone; an empty one keeps the zero it started from.
        return _zeros(data, num_segments).scatter_reduce_(
            0, index, data, reduce=reduce, include_self=False)[:num_segments]
    # Floating segments start from -inf (+inf for a min), not 0: the
    # backward of scatter_reduce counts the starting value among the tied
    # winners even with include_self=False, so a winner of 0 would share
    # its cotangent with the start (ROADMAP C23). The start equals only a
    # winner of -inf (+inf) or an empty segment, both of which give 0 here
    # and so carry no gradient.
    fill = -inf if reduce == "amax" else inf
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        fill).scatter_reduce_(
        0, index, data, reduce=reduce, include_self=False)[:num_segments]
    # a -inf winner of a max (+inf of a min) gives 0, as in the JAX
    # package, so an edge softmax over all-masked scores gives 0, not NaN
    return out.masked_fill(out == fill, 0.0)


def segment_max(data, segment_ids, num_segments):
    """Max of ``data`` rows per segment; empty segments, and a winner of
    -inf, give 0."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments):
    """Min of ``data`` rows per segment; empty segments, and a winner of
    +inf, give 0."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")


# The reference tells sorted `segment_*` from `unsorted_segment_*`; a
# scatter handles both orders, so the unsorted names are aliases, as in the
# JAX package.
unsorted_segment_sum = segment_sum
unsorted_segment_mean = segment_mean
unsorted_segment_max = segment_max
unsorted_segment_min = segment_min
