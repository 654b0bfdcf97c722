"""hgt_roofline.serve: the fused HGT attention's share of its roofline in a
request: the bytes each relation's attention needs (q, k and v read, the
output written, the CSR; harness/work.py) at the card's peak bandwidth,
over the device time of `csrc/hetero_flash.cu`'s forward kernel (row 13
of the port's kernel table), in %. Nothing matched: no value."""

from harness.work import attention_bytes, least_seconds_by_bytes

PATTERN = r"^hgt_fwd_kernel$"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "request" or tr is None:
        return None
    busy = tr.seconds(PATTERN)
    items = [it for it in ctx["work"].get("attention", [])
             if it["pass"] == "fwd"]
    if not busy or not items:
        return None
    return (least_seconds_by_bytes(items, attention_bytes) * tr.units / busy
            * 100)
