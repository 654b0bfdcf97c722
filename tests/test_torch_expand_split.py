"""The expand kernel's schedule and arithmetic, emulated in numpy, against
the plain version.

On the card the expand (`_expand` in `ops/cuda/sddmm_csr.py`, the kernel
in `csrc/sddmm_csr.cu`) cuts the plan's rows into work items of at most
`EDGE_SPLIT` consecutive CSR edges and gives each item one warp. An
item's output out[lo*C, hi*C) is one contiguous run; from its first
16-byte boundary on, the warp stores 32 16-byte chunks a round (where
rows are no multiple of 16 bytes, one aligned 512-byte span a round, the
lanes rotated by the run's first slot), a lane's column and edge stepped
by fixed increments, lanes 0..P-2 the elements before that boundary and
lanes 8.. those after the last whole chunk. A chunk inside the row is
read as the two aligned 16-byte blocks that hold it and shifted into
place word by word (a select of the first word, then funnel shifts); a
chunk that wraps to the row's start is read element by element. The
scaled form reads a chunk's scale once where a chunk lies in one head
(rows of a multiple of 16 bytes, x on 16 bytes, heads of a multiple of
16 bytes), else once an element, the head stepped with the column.

Here that walk is emulated lane by lane in numpy, on the raw bits, for
widths whose rows are and are not a multiple of 16 bytes, x on and off
16 bytes, at several item sizes, on a graph with a star row and rows
without edges: every output element is written exactly once, every
chunk store is 16-byte aligned and each round of the warp's stores
fills consecutive slots (of one aligned span, where rows are no multiple
of 16 bytes), the copy is bitwise the plain version, and the scaled form
is bitwise the plain version's single f32 product rounded once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda.sddmm_csr import EDGE_SPLIT

_CSRC = Path(kops.__file__).resolve().parents[2] / "csrc"
# lanes of a warp, read from the kernels' shared header
WARP = int(re.search(r"constexpr int kWarp = (\d+);",
                     (_CSRC / "common.cuh").read_text())[1])
_MASK = (1 << 32) - 1


def _graph(seed, n_dst=50, n_src=60, e=120, star=300):
    """A star of ``star`` edges into row 0, ``e`` random edges into even
    rows below 24: odd rows and rows 24.. get none."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          2 * rng.integers(0, 12, e)])
    src = rng.integers(0, n_src, dst.shape[0])
    return kops.build_csr_plan(src, dst, n_dst, num_src=n_src)


class _Emulation:
    """One launch's state: x as bytes at a byte offset ``x_off`` of its
    buffer (the out buffer starts on 16 bytes, as torch.empty's does), the
    output elements' bits and how often each was written."""

    def __init__(self, x, x_off, scale):
        self.C = x.shape[1]
        self.size = x.element_size()
        self.P = 16 // self.size
        self.raw = np.dtype(np.uint32 if self.size == 4 else np.uint16)
        bits = x.contiguous().view(torch.int32 if self.size == 4
                                   else torch.int16).numpy().view(self.raw)
        self.xb = np.zeros(x_off + bits.nbytes + 32, np.uint8)
        self.xb[x_off:x_off + bits.nbytes] = bits.reshape(-1).view(np.uint8)
        self.x_off = x_off
        self.xbits = bits
        self.scale = None if scale is None else scale.numpy()
        self.H = 1 if scale is None else scale.shape[1]
        self.Fh = self.C // self.H
        self.dtype = x.dtype

    def word(self, byte):
        return int(self.xb[byte:byte + 4].view(np.uint32)[0])

    def row_chunk(self, row, c):
        """The chunk's P elements' bits, as the kernel assembles them."""
        C, P = self.C, self.P
        if c + P <= C:
            a = self.x_off + (row * C + c) * self.size
            base, s = a & ~15, a & 15
            b = [self.word(base + 4 * k) for k in range(4)]
            b += ([self.word(base + 16 + 4 * k) for k in range(4)]
                  if s else b[:4])
            ws, sh = s >> 2, (s & 3) * 8
            v = [b[k + ws] for k in range(5)]
            w = [((v[k + 1] << 32 | v[k]) >> sh) & _MASK for k in range(4)]
        else:
            w, cc = [0] * 4, c
            for i in range(P):
                bits = int(self.xbits[row, cc])
                if self.size == 4:
                    w[i] = bits
                else:
                    w[i // 2] |= bits << (16 * (i % 2))
                cc = 0 if cc + 1 == C else cc + 1
        if self.size == 4:
            return w
        return [(wd >> (16 * h)) & 0xFFFF for wd in w for h in (0, 1)]

    def value(self, bits):
        """f32 value of one element's bits."""
        b = np.uint32(bits if self.size == 4 else bits << 16)
        return np.float32(b.view(np.float32))

    def rounded(self, f):
        """The bits of f32 value f rounded once to x's dtype."""
        t = torch.tensor([f], dtype=torch.float32).to(self.dtype)
        t = t.view(torch.int32 if self.size == 4 else torch.int16)
        return int(t.numpy().view(self.raw)[0])


def _emulate(x, plan, K, x_off=0, scale=None):
    """The expand's output bits (E, C) and write counts, by the kernel's
    walk over the items at K."""
    em = _Emulation(x, x_off, scale)
    C, P, H, Fh = em.C, em.P, em.H, em.Fh
    E = plan.num_edges
    out = np.zeros(E * C, np.int64)
    writes = np.zeros(E * C, np.int64)
    split = plan.row_split(K)
    aligned = C % P == 0 and x_off % 16 == 0
    head_chunk = scale is not None and aligned and Fh % P == 0
    inc_c, inc_e = (WARP * P) % C, (WARP * P) // C

    def put(idx, bits):
        out[idx] = bits
        writes[idx] += 1

    def one(row, e, c):  # expand_one
        bits = int(em.xbits[row, c])
        if scale is not None:
            bits = em.rounded(em.value(bits) * em.scale[e, c // Fh])
        put(e * C + c, bits)

    for i in range(split.item_row.shape[0]):
        row = int(split.item_row[i])
        lo, hi = int(split.item_ptr[i]), int(split.item_ptr[i + 1])
        n = hi - lo
        length = n * C
        pro = 0
        if not aligned:
            off = (lo * C * em.size) & 15  # out starts on 16 bytes
            pro = min(((16 - off) & 15) // em.size, length)
        chunks = (length - pro) // P
        tail = length - pro - chunks * P
        base16 = (lo * C + pro) * em.size // 16  # out starts on 512 bytes
        r = 0 if aligned else base16 % WARP
        rounds = {}  # round -> (16-byte slot - lane) of each of its stores
        for lane in range(WARP):
            if not aligned:
                if lane < pro:
                    one(row, lo + lane // C, lane % C)
                elif lane >= 8 and lane - 8 < tail:
                    m = lane - 7
                    one(row, lo + n - 1 - (m - 1) // C, C - 1 - (m - 1) % C)
            q0 = lane - r
            qf = q0 + WARP if q0 < 0 else q0
            if qf >= chunks:
                continue
            j = pro + qf * P
            e, c = j // C, j % C
            for q in range(q0, chunks, WARP):
                if q < 0:
                    continue
                rounds.setdefault((q - q0) // WARP, set()).add(
                    base16 + q - lane)
                first = lo * C + pro + q * P
                assert first * em.size % 16 == 0  # a 16-byte store
                if aligned:  # one 16-byte load of x
                    assert (x_off + (row * C + c) * em.size) % 16 == 0
                bits = em.row_chunk(row, c)
                if scale is None:
                    vals = bits
                else:
                    xv = [em.value(b) for b in bits]
                    srow, h = lo + e, c // Fh
                    if head_chunk:
                        sc = em.scale[srow, h]
                        vals = [em.rounded(sc * v) for v in xv]
                    else:
                        ch, vals = c - h * Fh, []
                        for k in range(P):
                            vals.append(em.rounded(em.scale[srow, h] * xv[k]))
                            ch += 1
                            if ch == Fh:
                                ch, h = 0, h + 1
                                if h == H:
                                    h, srow = 0, srow + 1
                for k in range(P):
                    put(first + k, vals[k])
                c += inc_c
                e += inc_e
                if c >= C:
                    c -= C
                    e += 1
        # a round's stores fill 32 consecutive slots; where rows are no
        # multiple of 16 bytes, from an aligned 512-byte span's start
        assert all(len(v) == 1 and (aligned or min(v) % WARP == 0)
                   for v in rounds.values())
    return out.reshape(E, C), writes


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16).numpy().astype(np.int64) \
        & (_MASK if t.element_size() == 4 else 0xFFFF)


@pytest.mark.parametrize("C,H", [(1, 1), (7, 7), (13, 1), (16, 8), (40, 1),
                                 (64, 8), (349, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_off", ["aligned", "one element"])
@pytest.mark.parametrize("K", [16, EDGE_SPLIT])
def test_expand_walk_writes_every_element_once(C, H, dtype, x_off, K):
    """The copy bitwise the plain version and the scaled form bitwise its
    single rounded product, every element written once."""
    plan = _graph(C)
    g = torch.Generator().manual_seed(C)
    x = torch.randn(plan.num_nodes, C, generator=g).to(dtype)
    scale = torch.randn(plan.num_edges, H, generator=g)
    off = 0 if x_off == "aligned" else x.element_size()
    assert 0 in plan.row_split(K).cut_row.tolist()  # the star is cut
    got, writes = _emulate(x, plan, K, off)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, _bits(kops.expand_dst_csr_reference(x, plan)))
    got, writes = _emulate(x, plan, K, off, scale)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, _bits(kops.expand_dst_csr_reference(x, plan, scale)))


def test_expand_walk_without_edges_and_tiny_items():
    """E = 0 writes nothing; items of one edge at K = 1, with rows of
    fewer elements than a chunk, are written by the scalar prologue and
    epilogue alone."""
    none = np.zeros(0, np.int64)
    empty = kops.build_csr_plan(none, none, 5, num_src=3)
    x = torch.randn(5, 3)
    got, writes = _emulate(x, empty, EDGE_SPLIT)
    assert got.shape == (0, 3) and writes.size == 0
    plan = _graph(3, e=20, star=5)
    x = torch.randn(plan.num_nodes, 3).to(torch.bfloat16)
    got, writes = _emulate(x, plan, 1)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        got, _bits(kops.expand_dst_csr_reference(x, plan)))
