"""A roofline model of halo-partitioned full-graph training's scaling,
counterpart of `gammagl_tpu/parallel/scaling.py`.

Per part and layer, the halo tiers do
  compute: the local SpMM over the part's edges (bound by the gather of
           source rows, not by arithmetic) and dense matmuls;
  comm:    the exchange of the boundary rows, over the fast links inside a
           slice and, in the two-level tier, the slower link between
           slices.

The efficiency follows from those two terms: the planned tiers overlap the
exchange with the interior sum (`parallel.halo_plan`), so their layer
takes the larger of the two; the flat tiers pay their sum.

`HwModel` keeps the JAX package's field names: ``ici_gbps`` is the link
within a slice (on the card: NVLink between the GPUs of a host) and
``dcn_gbps`` the link between slices (the network between hosts).
`HwModel()`'s defaults are an NVIDIA H100 SXM's (see `HwModel`).
"""

from typing import NamedTuple

__all__ = ["HwModel", "halo_scaling_estimate"]


class HwModel(NamedTuple):
    """One card's rates. The defaults are an NVIDIA H100 80GB HBM3 at a
    700.00 W power limit (`nvidia-smi`'s name and power.limit):

    * ``hbm_gbps``: a device-to-device copy of 1 GiB in bf16, bytes read
      plus bytes written over its time, CUDA events (`chip_smoke.py`
      phase 40: 3028.1 GB/s);
    * ``spmm_edges_per_s``: the planned tier's forward on the papers
      shard at scale 0.01 (one part, bf16 F = 256, 17,267,457 edges with
      self-loops, 9.642 ms a call), edges over its time (`chip_smoke.py`
      phase 24);
    * ``ici_gbps``: NVLink 4, one direction of its 900 GB/s (NVIDIA's
      published H100 SXM figure, not measured);
    * ``dcn_gbps``: one 400 Gb/s InfiniBand NDR port a GPU, as in a DGX
      H100 (published, not measured);
    * ``bf16_tflops``: the tensor cores' dense bf16 peak (published).
    """
    hbm_gbps: float = 3028.1
    ici_gbps: float = 450.0
    dcn_gbps: float = 50.0
    bf16_tflops: float = 989.0
    spmm_edges_per_s: float = 1.7908e9


def halo_scaling_estimate(num_parts, edges_per_part, halo_rows_sent,
                          feat_dim, itemsize=2, hw: HwModel = HwModel(),
                          dcn_rows_sent=0, overlap=True,
                          total_edges=None):
    """Roofline estimate of a halo-partitioned SpMM's scaling efficiency
    (the JAX package's model and dict).

    Args:
      num_parts: parts of the partition.
      edges_per_part: the most edges one part owns (padded count).
      halo_rows_sent: boundary rows one part sends a layer within its
        slice (summed over peers; it receives about as many).
      feat_dim: width of the exchanged and aggregated activations.
      itemsize: bytes an element (2: bf16).
      dcn_rows_sent: rows that cross between slices (the two-level tier).
      overlap: True models the planned tiers (the exchange hidden behind
        the interior sum), False the flat tiers (in series).
      total_edges: the graph's real edges (default: edges_per_part *
        num_parts, padding included).

    Returns a dict of per-layer times (s), the bytes moved and the
    estimated efficiency: useful edges a second against num_parts cards
    each at the single-card rate.
    """
    t_compute = edges_per_part / hw.spmm_edges_per_s
    ici_bytes = halo_rows_sent * feat_dim * itemsize
    dcn_bytes = dcn_rows_sent * feat_dim * itemsize
    t_ici = ici_bytes / (hw.ici_gbps * 1e9)
    t_dcn = dcn_bytes / (hw.dcn_gbps * 1e9)
    t_comm = t_ici + t_dcn
    if overlap:
        t_layer = max(t_compute, t_comm)
    else:
        t_layer = t_compute + t_comm
    if total_edges is None:
        total_edges = edges_per_part * num_parts  # padding included
    eff = ((total_edges / t_layer) / (num_parts * hw.spmm_edges_per_s)
           if t_layer > 0 else 1.0)
    return {
        "num_parts": int(num_parts),
        "t_compute_s": t_compute,
        "t_ici_s": t_ici,
        "t_dcn_s": t_dcn,
        "t_layer_s": t_layer,
        "ici_bytes": int(ici_bytes),
        "dcn_bytes": int(dcn_bytes),
        "overlap": bool(overlap),
        "efficiency": float(min(eff, 1.0)),
    }
