"""Losses and metrics (counterpart of `gammagl_tpu/train/metrics.py`)."""

import torch
import torch.nn.functional as F

__all__ = ["semi_supervised_loss", "accuracy", "micro_f1", "macro_f1"]


def semi_supervised_loss(logits, labels, mask):
    """Masked mean cross-entropy over the nodes where ``mask`` is set,
    computed in float32. ``logits`` (..., C) broadcast against ``labels``
    as in the JAX package: one row of logits (1, C) serves every label
    (a model that pools the whole graph, ROADMAP C17)."""
    shape = torch.broadcast_shapes(logits.shape[:-1], labels.shape)
    logits = logits.float().expand(*shape, logits.shape[-1])
    ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.long().expand(shape).reshape(-1),
                         reduction="none").reshape(shape)
    mask = mask.float()
    return (ll * mask).sum() / mask.sum().clamp_min(1)


def accuracy(logits, labels, mask=None):
    """Share of (masked) nodes whose argmax is the label; the argmax
    broadcasts against ``labels`` as in `semi_supervised_loss`."""
    correct = (logits.argmax(-1) == labels).float()
    if mask is None:
        return correct.mean()
    mask = mask.float()
    return (correct * mask).sum() / mask.sum().clamp_min(1)


def micro_f1(logits, labels, mask=None):
    """Micro-averaged F1 of single-label predictions: the (masked)
    accuracy."""
    return accuracy(logits, labels, mask)


def _class_counts(values, num_classes):
    """How often each class in [0, num_classes) occurs in ``values``."""
    inside = (values >= 0) & (values < num_classes)
    return torch.bincount(values[inside], minlength=num_classes).float()


def macro_f1(logits, labels, num_classes=None):
    """The mean over classes of each class's F1 (a class never predicted
    nor present counts 0), float32. ``num_classes`` defaults to the
    logits' width."""
    pred = logits.argmax(-1)
    labels = labels.long()
    if num_classes is None:
        num_classes = int(logits.shape[-1])
    tp = _class_counts(pred[pred == labels], num_classes)
    fp = _class_counts(pred, num_classes) - tp
    fn = _class_counts(labels, num_classes) - tp
    precision = tp / (tp + fp).clamp_min(1)
    recall = tp / (tp + fn).clamp_min(1)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
    return f1.mean()
