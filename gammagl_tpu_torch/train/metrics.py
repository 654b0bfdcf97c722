"""Losses and metrics (counterpart of `gammagl_tpu/train/metrics.py`)."""

import torch.nn.functional as F

__all__ = ["semi_supervised_loss", "accuracy"]


def semi_supervised_loss(logits, labels, mask):
    """Masked mean cross-entropy over the nodes where ``mask`` is set,
    computed in float32."""
    ll = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    mask = mask.float()
    return (ll * mask).sum() / mask.sum().clamp_min(1)


def accuracy(logits, labels, mask=None):
    """Share of (masked) nodes whose argmax is the label."""
    correct = (logits.argmax(-1) == labels).float()
    if mask is None:
        return correct.mean()
    mask = mask.float()
    return (correct * mask).sum() / mask.sum().clamp_min(1)
