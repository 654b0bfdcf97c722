"""Process-wide default compute dtype (counterpart of
`gammagl_tpu/utils/compute_dtype.py`).

Parameters stay float32; a layer whose ``dtype`` is None computes in the
default set here, so a whole model switches to bfloat16 with one line:

    from gammagl_tpu_torch.utils import compute_dtype
    with compute_dtype(torch.bfloat16):
        logits = model(x, edge_index)

PyTorch runs eagerly, so the default is read at every call.
"""

import contextlib

__all__ = ["set_compute_dtype", "get_compute_dtype", "compute_dtype",
           "resolve_dtype"]

_COMPUTE_DTYPE = None


def set_compute_dtype(dtype):
    """Set the process-wide default compute dtype (None = float32)."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def get_compute_dtype():
    return _COMPUTE_DTYPE


@contextlib.contextmanager
def compute_dtype(dtype):
    """Scoped default: ``with compute_dtype(torch.bfloat16): ...``"""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev


def resolve_dtype(local=None):
    """A layer's effective compute dtype: its own setting, else the
    default."""
    return local if local is not None else _COMPUTE_DTYPE
