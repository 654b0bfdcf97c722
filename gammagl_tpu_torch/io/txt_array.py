"""Delimited text arrays (counterpart of `gammagl_tpu/io/txt_array.py`;
reference: gammagl/io/txt_array.py)."""

import numpy as np

__all__ = ["read_txt_array", "parse_txt_array"]


def parse_txt_array(src, sep=None, start=0, end=None, dtype=np.int64):
    """Lines of ``sep``-separated numbers (columns ``start:end``) as one
    array of ``dtype``; one column gives a 1-D array."""
    out = [[float(v) for v in line.split(sep)[start:end]]
           for line in src if line.strip()]
    arr = np.asarray(out, dtype=np.float64)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr.reshape(-1)
    return arr.astype(dtype)


def read_txt_array(path, sep=None, start=0, end=None, dtype=np.int64):
    with open(path) as f:
        return parse_txt_array(f.read().split("\n"), sep, start, end, dtype)
