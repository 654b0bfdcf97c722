"""Where the port's entry points run: on the CUDA card unless the caller
asks for another device."""

import torch

__all__ = ["resolve_device"]


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
