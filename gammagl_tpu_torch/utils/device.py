"""Where the port's entry points run: on the CUDA card unless the caller
asks for another device; and how host arrays get there."""

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]

# rows of a read-only array copied at a time by `to_device`
_CHUNK_BYTES = 64 << 20


def resolve_device(device=None):
    """``device`` as a `torch.device`; None means the current CUDA card.
    A CUDA device raises when torch sees no card: nothing falls back to
    the CPU, which runs only when asked for (``"cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch sees "
                               "no CUDA device (pass 'cpu' to run the plain "
                               "versions on the host)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(arr, device=None, dtype=None):
    """A numpy array (or a tensor) as a tensor on ``device`` (None: the
    card) in ``dtype`` (None: its own).

    A read-only array (a memory map opened with ``mmap_mode="r"``, as the
    OGB loader opens its npy files) is copied in slices of at most 64 MiB
    into the tensor, so no warning is raised about memory torch would
    treat as writable and no second host copy of the whole array is
    made; on the host the tensor itself is the one copy."""
    device = resolve_device(device)
    if isinstance(arr, torch.Tensor):
        return arr.to(device, dtype=dtype)
    arr = np.asarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device, dtype=dtype)
    like = torch.from_numpy(np.empty((0,), arr.dtype))
    out = torch.empty(arr.shape, dtype=dtype or like.dtype, device=device)
    if arr.ndim == 0 or arr.size == 0:
        return out.copy_(torch.from_numpy(np.array(arr)))
    rows = max(1, _CHUNK_BYTES // max(arr[0].nbytes, 1))
    for lo in range(0, arr.shape[0], rows):
        out[lo:lo + rows] = torch.from_numpy(np.array(arr[lo:lo + rows]))
    return out
