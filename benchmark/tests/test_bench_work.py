"""The yardstick's counts of bytes and operations against hand counts."""

import pytest

from harness import work


def test_spmm_counts_by_hand():
    # 3 destinations, 4 sources, 5 edges, width 2, bf16
    it = {"rows": 3, "cols": 4, "edges": 5, "width": 2, "itemsize": 2}
    # x 4*2*2 = 16, edges 5*(4+4) = 40, rowptr 4*8 = 32, out 3*2*2 = 12
    assert work.spmm_bytes(it) == 16 + 40 + 32 + 12
    assert work.spmm_flops(it) == 2 * 5 * 2


def test_attention_counts_by_hand():
    it = {"dst": 3, "src": 4, "edges": 5, "heads": 2, "dim": 8,
          "itemsize": 2, "pass": "fwd"}
    hd = 16
    csr = 5 * 4 + 4 * 8
    assert work.attention_bytes(it) == (3 * hd + 2 * 4 * hd + 3 * hd) * 2 \
        + csr
    assert work.attention_flops(it) == 4 * 5 * 2 * 8
    bwd = dict(it, **{"pass": "bwd"})
    assert work.attention_bytes(bwd) == (3 * 3 * hd + 2 * 4 * hd + 3 * hd
                                         + 2 * 4 * hd) * 2 + csr
    assert work.attention_flops(bwd) == 2 * 4 * 5 * 2 * 8


def test_least_seconds_by_dtype():
    w = {"matmul": [{"m": 10, "k": 20, "n": 30, "dtype": "bfloat16"},
                    {"m": 10, "k": 20, "n": 30, "dtype": "float32"}],
         "spmm": [{"rows": 3, "cols": 4, "edges": 5, "width": 2,
                   "itemsize": 2, "dtype": "bfloat16"}]}
    want = (2 * 10 * 20 * 30 / 989e12 + 2 * 10 * 20 * 30 / 67e12
            + 2 * 5 * 2 / 989e12)
    assert work.least_seconds_by_flops(w) == pytest.approx(want, rel=1e-12)
    assert work.least_seconds_by_bytes(
        w["spmm"], work.spmm_bytes) == pytest.approx(100 / 3.35e12)


def test_gcn_step_work_by_hand():
    import run
    cell = run.Cell(run.ROOT, "gcn-papers100m-1pct.train")
    model = cell.module("model")
    n, e = 10, 40
    w = model.work(cell.cfg, n, e)
    # 3 forward aggregations (128, 256, 256) and 2 on the transpose (256)
    assert [s["width"] for s in w["spmm"]] == [128, 256, 256, 256, 256]
    flops = sum(work.matmul_flops(m) for m in w["matmul"])
    fwd = 2 * n * (128 * 256 + 256 * 256 + 256 * 172)
    dx = 2 * n * (256 * 256 + 172 * 256)
    assert flops == 2 * fwd + dx
