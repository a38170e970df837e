"""The depthwise-conv kernel's plan (``rpeflow_tpu_torch/ops/dwconv.py :
dwconv_plan``) and its index arithmetic, checked on the CPU.

At the 38 shapes of one training step (``chip_smoke.dwconv_shapes``) and
the edge shapes the kernel is held to on the card
(``chip_smoke.DWCONV_EDGE_SHAPES``): every channel, column and row is taken
by exactly one thread of one block; a block fits 256 threads and the
launch's 48 KB of shared memory; the blocks are as many as the card runs at
once; the backward's scratch is its per-block partials.
Then the kernel's arithmetic, written out in torch as ``csrc/dwconv.cu``
does it (the rolling window's rows and the rotated taps read by index, the
units walked by each backward block), against the plain versions: forward
and input gradient atol 1e-5, taps gradient within 1e-4 of its largest
entry.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import DWCONV_EDGE_SHAPES, dwconv_shapes
from rpeflow_tpu_torch.ops import dwconv

SHAPES = sorted(set(dwconv_shapes() + DWCONV_EDGE_SHAPES))


def _plans(shape, **kw):
    return dwconv.dwconv_plan(*shape, **kw), dwconv.dwconv_plan(*shape, backward=True, **kw)


# the default plans, and plans of 7-row strips (strips cut by the map's edge)
_KW = [{}, {"rh": 7}]


@pytest.mark.parametrize("kw", _KW, ids=["plan", "rh7"])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_element_taken_once(shape, kw):
    b, h, w, c, kh = shape
    for plan in _plans(shape, **kw):
        cg = c // plan.v
        # channels: channel block chb, lane, vector element
        ch = np.zeros(c, np.int64)
        for chb in range(plan.ch_blocks):
            for lane in range(plan.cgb):
                gi = chb * plan.cgb + lane
                if gi < cg:
                    ch[gi * plan.v:(gi + 1) * plan.v] += 1
        # columns: column tile ct, thread row ty, the thread's column k
        cols = np.zeros(w, np.int64)
        for ct in range(plan.col_tiles):
            for ty in range(plan.cols // plan.tx):
                for k in range(plan.tx):
                    if ct * plan.cols + ty * plan.tx + k < w:
                        cols[ct * plan.cols + ty * plan.tx + k] += 1
        rows = np.zeros(h, np.int64)
        for s in range(plan.strips):
            rows[s * plan.rh:min(s * plan.rh + plan.rh, h)] += 1
        assert (ch == 1).all() and (cols == 1).all() and (rows == 1).all(), plan
        assert (plan.strips - 1) * plan.rh < h


@pytest.mark.parametrize("kw", _KW, ids=["plan", "rh7"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_the_launch(shape, kw):
    b, h, w, c, kh = shape
    fwd, bwd = _plans(shape, **kw)
    for plan in (fwd, bwd):
        assert c % plan.v == 0 and plan.cgb * plan.cols // plan.tx <= dwconv.THREADS
        assert plan.cols % plan.tx == 0 and plan.cols // plan.tx >= 2
        assert plan.cgb == min(c // plan.v, 32) and 1 <= plan.rh <= dwconv.MAX_ROWS
        if not kw:  # strips of at least MIN_ROWS
            assert plan.strips <= -(-h // min(h, dwconv.MIN_ROWS))
        assert plan.smem_bytes <= dwconv.SMEM_LIMIT
        # as many blocks as run at once, or one unit each
        resident = 132 * dwconv.BLOCKS_PER_SM // plan.ch_blocks
        assert plan.nb == min(plan.units, max(1, resident)) and plan.nb <= 65535
        assert list(plan.c_plan[0]) == [b, h, w, c, kh, plan.v, plan.cgb, plan.cols, plan.rh,
                                        plan.nb, plan.tx]
    assert fwd.v == max(v for v in (1, 2, 4) if c % v == 0)
    assert bwd.v == (2 if c % 2 == 0 else 1)
    assert fwd.tx == (1 if fwd.v == 4 else 2) and bwd.tx == 2
    assert fwd.scratch_floats == 0 and bwd.scratch_floats == bwd.nb * kh * 3 * c
    if kh == 1:
        assert fwd.rh == bwd.rh == 1


def _window(z, plan, u):
    """Unit ``u``'s batch element, rows and columns, and its rolling window
    over the zero-padded map: ``win[r][j]`` is rows ``y - kh//2 + r`` and
    columns ``x - 1 + j`` for every row y and column x of the unit."""
    kh = plan.kh
    ct, bs = u % plan.col_tiles, u // plan.col_tiles
    bb, y0 = bs // plan.strips, (bs % plan.strips) * plan.rh
    y1, c0 = min(y0 + plan.rh, plan.h), ct * plan.cols
    c1 = min(c0 + plan.cols, plan.w)
    zp = F.pad(z, (0, 0, 1, 1, kh // 2, kh // 2))
    win = [[zp[bb, y0 + r:y1 + r, c0 + j:c1 + j] for j in range(3)] for r in range(kh)]
    return (bb, slice(y0, y1), slice(c0, c1)), win


def emulate_fwd(x, taps, plan):
    out = torch.empty_like(x)
    kh = plan.kh
    for u in range(plan.units):
        at, win = _window(x, plan, u)
        out[at] = sum(win[i][j] * taps[i, j] for i in range(kh) for j in range(3))
    return out


def emulate_bwd(x, g, taps, plan):
    """dx pairs window row r with taps row kh - 1 - r and column j with taps
    column 2 - j; the taps products x[y, x] * win[kh - 1 - i][2 - j] are
    summed per backward block (block k takes units k, k + nb, ...), then
    over the blocks."""
    kh = plan.kh
    dx = torch.empty_like(x)
    part = torch.zeros(plan.nb, kh, 3, x.shape[-1], dtype=torch.float64)
    for u in range(plan.units):
        at, win = _window(g, plan, u)
        dx[at] = sum(win[r][j] * taps[kh - 1 - r, 2 - j] for r in range(kh) for j in range(3))
        xc = x[at]
        for i in range(kh):
            for j in range(3):
                part[u % plan.nb, i, j] += (xc * win[kh - 1 - i][2 - j]).sum((0, 1)).double()
    return dx, part.sum(0).float()


_EMULATED = [s for s in SHAPES if s[0] * s[1] * s[2] * s[3] <= 2_000_000]


@pytest.mark.parametrize("forced", [False, True], ids=["plan", "rh7-nb5"])
@pytest.mark.parametrize("shape", _EMULATED)
def test_kernel_arithmetic_matches_plain(shape, forced):
    b, h, w, c, kh = shape
    rng = np.random.RandomState(c + h)
    x, g = (torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)) for _ in range(2))
    taps = torch.from_numpy((rng.randn(kh, 3, c) / 3).astype(np.float32))
    extra = dict(rh=7) if forced else {}
    fwd = dwconv.dwconv_plan(*shape, **extra)
    bwd = dwconv.dwconv_plan(*shape, backward=True, **extra, **(dict(nb=5) if forced else {}))
    torch.testing.assert_close(emulate_fwd(x, taps, fwd), dwconv.dwconv_plain(x, taps),
                               atol=1e-5, rtol=0)
    dx, dtaps = emulate_bwd(x, g, taps, bwd)
    ref_dx, ref_dtaps = dwconv.dwconv_bwd_plain(x, g, taps)
    torch.testing.assert_close(dx, ref_dx, atol=1e-5, rtol=0)
    assert float((dtaps - ref_dtaps).abs().max()) <= 1e-4 * float(ref_dtaps.abs().max())


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        dwconv.dwconv_plan(1, 4, 4, 8, 2)
    with pytest.raises(ValueError):
        dwconv.dwconv_plan(0, 4, 4, 8, 3)
