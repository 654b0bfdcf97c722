"""Edge softmax: the attention primitive behind GAT (counterpart of
`gammagl_tpu/ops/softmax.py`).

Max-shift, exp, segment sum, divide. Entries whose segment id is out of
range (padding) get 0 and add nothing to any denominator.
"""

import torch

from gammagl_tpu_torch.ops.segment import segment_max, segment_sum

__all__ = ["segment_softmax"]


def segment_softmax(data, segment_ids, num_segments):
    """Softmax over the entries of ``data`` (E, ...) that share a segment
    id (per destination node). Computed in float32 and returned in
    ``data``'s dtype."""
    x = data.float()
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = segment_ids.long().clamp(0, max(num_segments - 1, 0))
    shifted = x - segment_max(x, segment_ids, num_segments)[ids]
    valid = valid.reshape((-1,) + (1,) * (data.dim() - 1))
    exp = torch.where(valid, shifted.exp(), 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    return (exp / (denom[ids] + 1e-16)).to(data.dtype)
