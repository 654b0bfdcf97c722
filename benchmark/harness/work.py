"""The yardstick: the card's published peaks and the operations and bytes
that a model's mathematics needs, counted from shapes.

Every count is of the mathematics, not of an implementation: each input
byte is read once and each output byte written once (features, CSR
indices and weights, outputs), with no padding, cut-row partials or
re-reads, so a share reads the same whatever kernels do the work.

A model file describes one unit of work (a training step, a request) as
lists of items, each a dict of sizes:

* ``spmm``: one sparse aggregation out = A x over a CSR of ``edges``
  weighted edges: rows (destinations), cols (sources), width, itemsize.
  The CSR is counted as int64 row pointers, int32 columns and float32
  weights.
* ``matmul``: a dense product (m, k) @ (k, n) with ``dtype``.
* ``attention``: one relation's softmax attention over ``edges`` edges
  (``dst``, ``src`` nodes, ``heads`` x ``dim``, itemsize), ``pass`` fwd
  (scores, softmax, weighted sum) or bwd (its gradients in q, k and v).
"""

# NVIDIA H100 SXM, published dense peaks (no sparsity), at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "float8": 1979e12}
PEAK_BYTES_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"

_CSR_ROW, _CSR_COL, _CSR_W = 8, 4, 4


def spmm_bytes(it):
    return (it["cols"] * it["width"] * it["itemsize"]
            + it["edges"] * (_CSR_COL + _CSR_W)
            + (it["rows"] + 1) * _CSR_ROW
            + it["rows"] * it["width"] * it["itemsize"])


def spmm_flops(it):
    return 2 * it["edges"] * it["width"]


def matmul_flops(it):
    return 2 * it["m"] * it["k"] * it["n"]


def attention_bytes(it):
    hd, b = it["heads"] * it["dim"], it["itemsize"]
    csr = it["edges"] * _CSR_COL + (it["dst"] + 1) * _CSR_ROW
    if it["pass"] == "fwd":
        # q, k and v read, out written
        return (it["dst"] * hd + 2 * it["src"] * hd + it["dst"] * hd) * b + csr
    # q, k, v, out and its gradient read, dq, dk and dv written
    return (3 * it["dst"] * hd + 2 * it["src"] * hd
            + it["dst"] * hd + 2 * it["src"] * hd) * b + csr


def attention_flops(it):
    # a score (D multiply-adds) and a weighted sum (D) per edge and head;
    # the backward's four products (dp, dv, dq, dk) twice that
    per = 4 * it["edges"] * it["heads"] * it["dim"]
    return per if it["pass"] == "fwd" else 2 * per


def least_seconds_by_bytes(items, fn):
    return sum(fn(it) for it in items) / PEAK_BYTES_S


def least_seconds_by_flops(work):
    """The least time the unit's operations take at the peak of each
    item's dtype: sum over items of flops / peak."""
    t = 0.0
    for it in work.get("matmul", []):
        t += matmul_flops(it) / PEAK_FLOPS[it["dtype"]]
    for it in work.get("spmm", []):
        t += spmm_flops(it) / PEAK_FLOPS[it["dtype"]]
    for it in work.get("attention", []):
        t += attention_flops(it) / PEAK_FLOPS[it["dtype"]]
    return t
