"""spmm_roofline.train: the CSR aggregations' share of their roofline in a
training step: the bytes the step's aggregations need (harness/work.py)
at the card's peak bandwidth, over the device time of every launch of
`csrc/spmm_csr.cu`'s kernel (rows 1, 4 and 5 of the port's kernel table:
plain, per-edge and accumulating) and of its fold of cut rows, in %.
Nothing matched: no value."""

from harness.work import least_seconds_by_bytes, spmm_bytes

PATTERN = r"^(spmm_csr_kernel|csr_fold_kernel)$"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "step" or tr is None:
        return None
    busy = tr.seconds(PATTERN)
    items = ctx["work"].get("spmm", [])
    if not busy or not items:
        return None
    return least_seconds_by_bytes(items, spmm_bytes) * tr.units / busy * 100
