"""attn_roofline.train: the attention's share of its roofline in a training
step: the bytes each relation's attention needs forward and backward (q,
k and v read, the output written; the output's gradient read, dq, dk and
dv written; the CSR; harness/work.py) at the card's peak bandwidth, over
the device time of every kernel the attention runs on: the expand of q to
the edges and its per-edge segment sum (rows 9 and 4), the flash forward
and backward with the forward's fold (rows 10 and 11), and the source
gather's sum on the edge-scatter plan (row 1), in %. Nothing matched: no
value."""

from harness.work import attention_bytes, least_seconds_by_bytes

PATTERN = (r"^(expand_kernel|flash_fwd_kernel|flash_fwd_fold_kernel|"
           r"flash_bwd_kernel|flash_bwd_narrow_kernel|flash_bwd_wide_kernel|"
           r"spmm_csr_kernel|csr_fold_kernel)$")


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "step" or tr is None:
        return None
    busy = tr.seconds(PATTERN)
    items = ctx["work"].get("attention", [])
    if not busy or not items:
        return None
    return (least_seconds_by_bytes(items, attention_bytes) * tr.units / busy
            * 100)
