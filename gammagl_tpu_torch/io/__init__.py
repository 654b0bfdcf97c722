"""Raw-file readers (counterpart of `gammagl_tpu/io/`; reference:
gammagl/io/). Host numpy; each gives `Graph`s of numpy arrays."""

from gammagl_tpu_torch.io.txt_array import read_txt_array, parse_txt_array
from gammagl_tpu_torch.io.planetoid import read_planetoid_data
from gammagl_tpu_torch.io.npz import read_npz, parse_npz
from gammagl_tpu_torch.io.tu import read_tu_data

__all__ = [
    "read_txt_array",
    "parse_txt_array",
    "read_planetoid_data",
    "read_npz",
    "parse_npz",
    "read_tu_data",
]
