"""Sparse-format conversions and edge bookkeeping (counterpart of
`gammagl_tpu/ops/sparse.py`).

Two tiers, as in the JAX package: numpy versions for host-side graph
preprocessing (plans, loaders, `sparse.SparseGraph`), and tensor versions
that run where their input lives.
"""

import numpy as np
import torch

__all__ = ["ind2ptr", "ptr2ind", "ind2ptr_np", "ptr2ind_np", "unique_np"]


def ind2ptr(ind, M: int):
    """Sorted COO row indices (a tensor) -> CSR rowptr of length M + 1,
    int32, on ind's device: rowptr[r] is the number of indices below r."""
    rows = torch.arange(M + 1, device=ind.device, dtype=ind.dtype)
    return torch.searchsorted(ind, rows, side="left").to(torch.int32)


def ptr2ind(ptr, E: int):
    """CSR rowptr (a tensor) -> the row of each of the E nonzeros, int32."""
    entries = torch.arange(E, device=ptr.device, dtype=ptr.dtype)
    return torch.searchsorted(ptr[1:].contiguous(), entries,
                              side="right").to(torch.int32)


def ind2ptr_np(ind, M: int):
    """Host (numpy) `ind2ptr`."""
    ind = np.asarray(ind)
    return np.searchsorted(ind, np.arange(M + 1), side="left").astype(
        np.int32)


def ptr2ind_np(ptr, E: int = None):
    """Host (numpy) `ptr2ind`; E defaults to ptr[-1]."""
    ptr = np.asarray(ptr)
    if E is None:
        E = int(ptr[-1])
    return np.searchsorted(ptr[1:], np.arange(E), side="right").astype(
        np.int32)


def unique_np(x, return_inverse=False, return_counts=False):
    """Sorted unique values, with the inverse and the counts on request
    (`np.unique`)."""
    return np.unique(np.asarray(x), return_inverse=return_inverse,
                     return_counts=return_counts)
