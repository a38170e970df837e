"""The correlation kernel's plan (``rpeflow_tpu_torch/ops/correlation.py :
correlation_plan``) and its index arithmetic, checked on the CPU.

At the five decode levels' shapes (``chip_smoke.LEVELS``) and the edge shapes
the kernel is held to on the card (``chip_smoke.CORR_EDGE_SHAPES``), under
the default plans and under ``chip_smoke.CORR_EDGE_PLAN``: every output pixel
lies in exactly one tile, every (pixel, displacement) of a tile is one
thread's and every (pixel, channel) of a backward tile too; a block fits the
kernel's threads and the card's 232,448 bytes of shared memory; the
forward's row stores write each output float once, the 16-byte ones at
16-byte aligned offsets.

Then the kernel's arithmetic, written out in torch as ``csrc/correlation.cu``
does it (the swizzled 32-channel stages, the tile and halo origins, the
backward's A tiles: ``g`` for the first gradient, ``g[q + delta_k, K-1-k]``
gathered for the second, and the row stores), against the JAX
``correlation2d_ref`` (atol 1e-5) and ``_correlation2d_bwd_ref`` (the
tolerance of tests/test_torch_autograd.py : _close), on the same
numpy-seeded inputs.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CORR_EDGE_PLAN, CORR_EDGE_SHAPES, LEVELS
from rpeflow_tpu.ops.correlation import _correlation2d_bwd_ref, correlation2d_ref
from rpeflow_tpu_torch.ops import correlation
from rpeflow_tpu_torch.ops.correlation import CHUNK, PIXELS_PER_THREAD as R

SHAPES = [(4, h, w, c, 4) for h, w, c, _ in LEVELS] + CORR_EDGE_SHAPES
_KW = [{}, CORR_EDGE_PLAN]
_IDS = ["plan", "th3-tw32"]


def _plans(shape, **kw):
    return [correlation.correlation_plan(*shape, backward=bwd, **kw) for bwd in (False, True)]


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_pixel_in_one_tile_and_block_fits(shape, kw):
    b, h, w, c, d = shape
    side = 2 * d + 1
    for plan in _plans(shape, **kw):
        gx, gy, gz = plan.grid
        assert gz == (2 * b if plan.backward else b)
        cover = np.zeros((h, w), np.int64)
        for by in range(gy):
            for bx in range(gx):
                cover[by * plan.th:(by + 1) * plan.th, bx * plan.tw:(bx + 1) * plan.tw] += 1
        assert (cover == 1).all(), plan
        assert plan.threads <= correlation.MAX_THREADS and plan.smem_bytes <= 232_448
        assert plan.tw % R == 0 and plan.th <= correlation.MAX_TH
        assert list(plan.c_plan[0]) == [b, h, w, c, d, plan.th, plan.tw]
        t = np.arange(plan.threads)
        if plan.backward:
            # thread -> (row ty, pixel group, channel group): each (pixel,
            # channel) of a 32-channel chunk is one thread's
            cg, pg, ty = t & 7, (t >> 3) % (plan.tw // R), (t >> 3) // (plan.tw // R)
            cells = [(int(y), int(p) * R + j, int(g) * 4 + i)
                     for y, p, g in zip(ty, pg, cg) for j in range(R) for i in range(4)]
            assert sorted(cells) == [(y, x, ch) for y in range(plan.th)
                                     for x in range(plan.tw) for ch in range(CHUNK)]
        else:
            # thread -> (row r, displacement row dy, column group xg); its R
            # pixels and 2d + 1 column shifts: each (pixel, k) is one thread's
            nxg = plan.tw // R
            xg, dy, r = t % nxg, (t // nxg) % side, t // (nxg * side)
            cells = [(int(rr), int(x) * R + j, int(y) * side + dx)
                     for rr, y, x in zip(r, dy, xg) for j in range(R) for dx in range(side)]
            assert sorted(cells) == [(rr, x, k) for rr in range(plan.th)
                                     for x in range(plan.tw) for k in range(side * side)]


def _row_stores(g0, n):
    """The forward's stores of one tile row (csrc/correlation.cu), as offsets
    from ``g0``: the scalar head, the 16-byte body and the scalar tail."""
    head = min(n, (4 - (g0 & 3)) & 3)
    body = (n - head) // 4
    return np.arange(head), head + 4 * np.arange(body), np.arange(head + 4 * body, n)


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_row_stores_are_aligned_and_write_each_float_once(shape, kw):
    b, h, w, c, d = shape
    plan = correlation.correlation_plan(*shape, **kw)
    k = plan.k
    written = np.zeros(b * h * w * k, np.int64)
    for bb in range(b):
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                x0 = bx * plan.tw
                n = min(plan.tw, w - x0) * k
                for y in range(by * plan.th, min(by * plan.th + plan.th, h)):
                    g0 = ((bb * h + y) * w + x0) * k
                    head, body, tail = _row_stores(g0, n)
                    assert ((g0 + body) % 4 == 0).all()
                    np.add.at(written, g0 + np.concatenate([head, tail]), 1)
                    np.add.at(written, (g0 + body[:, None] + np.arange(4)).ravel(), 1)
    assert (written == 1).all()


# ---------------------------------------------------------------- emulation


def _swz(row, col):
    return ((col >> 2) ^ (row << 2)) & 7


def _stage(f, bb, c0, y0, x0, rows, cols):
    """One stage as the kernel fills it: channels [c0, c0 + 32) of the rows x
    cols window at (y0, x0), zero outside the frame and past C, stored
    [row][col][slot ^ swz] in a flat buffer; returns the buffer."""
    _, h, w, c = f.shape
    e = torch.arange(rows * cols * CHUNK)
    ch, pc = e % CHUNK, e // CHUNK
    col, row = pc % cols, pc // cols
    gy, gx = y0 + row, x0 + col
    ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w) & (c0 + ch < c)
    val = f[bb, gy.clamp(0, h - 1), gx.clamp(0, w - 1), (c0 + ch).clamp(max=c - 1)]
    dst = (pc * 8 + ((ch >> 2) ^ _swz(row, col))) * 4 + (ch & 3)
    assert torch.equal(torch.sort(dst).values, e)  # the swizzle is a permutation
    buf = torch.empty(rows * cols * CHUNK, dtype=f.dtype)
    buf[dst] = torch.where(ok, val, torch.zeros(()))
    return buf


def _read(buf, cols, rows):
    """Every (row, col) slot of a stage read back as the kernel reads it:
    ``[rows, cols, 32]``."""
    row = torch.arange(rows)[:, None, None]
    col = torch.arange(cols)[None, :, None]
    s = torch.arange(8)[None, None, :]
    base = ((row * cols + col) * 8 + (s ^ _swz(row, col))) * 4
    return buf[base[..., None] + torch.arange(4)].reshape(rows, cols, CHUNK)


def emulate_fwd(f1, f2, plan):
    b, h, w, c = f1.shape
    d, th, tw, k = plan.d, plan.th, plan.tw, plan.k
    side, rows, cols = 2 * d + 1, th + 2 * d, tw + 2 * d
    out = torch.full((b * h * w * k,), float("nan"))
    for bb in range(b):
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                y0, x0 = by * th, bx * tw
                acc = torch.zeros(th, tw, side, side, dtype=torch.float64)
                for c0 in range(0, c, CHUNK):
                    a = _read(_stage(f1, bb, c0, y0, x0, th, tw), tw, th).double()
                    v = _read(_stage(f2, bb, c0, y0 - d, x0 - d, rows, cols), cols, rows).double()
                    for dy in range(side):
                        for dx in range(side):
                            acc[:, :, dy, dx] += (a * v[dy:dy + th, dx:dx + tw]).sum(-1)
                tile = (acc.float() * (1.0 / c)).reshape(-1)  # [row][col][k]
                for rr in range(th):
                    if y0 + rr >= h:
                        break
                    g0 = ((bb * h + y0 + rr) * w + x0) * k
                    n = min(tw, w - x0) * k
                    out[g0:g0 + n] = tile[rr * tw * k:rr * tw * k + n]
    return out.reshape(b, h, w, k)


def _a_tile(g, bb, role, y0, x0, th, tw, d):
    """The backward block's A tile ``[th, tw, K]``, filled with the kernel's
    loops: ``g`` itself (role 0), or ``g[q + delta_k, K-1-k]`` gathered from
    the 2d + 1 contiguous floats of each source pixel (role 1)."""
    _, h, w, k = g.shape
    side, cols = 2 * d + 1, tw + 2 * d
    a = torch.full((th * tw * k,), float("nan"))
    if role == 0:
        e = torch.arange(th * tw * k)
        ty, rem = e // (tw * k), e % (tw * k)
        y, x = y0 + ty, x0 + rem // k
        ok = (y < h) & (x < w)
        flat = g[bb].reshape(-1)
        src = ((y * w + x0) * k + rem).clamp(max=flat.numel() - 1)
        a[e] = torch.where(ok, flat[src], torch.zeros(()))
        return a.reshape(th, tw, k)
    e = torch.arange(th * side * cols * side)
    m, sx = e % side, (e // side) % cols
    dy, ty = (e // (side * cols)) % side, e // (side * cols * side)
    tx = sx - 2 * d + m
    keep = (tx >= 0) & (tx < tw)
    gy, gx = y0 + ty + dy - d, x0 - d + sx
    ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    val = g[bb, gy.clamp(0, h - 1), gx.clamp(0, w - 1), (2 * d - dy) * side + m]
    dst = (ty * tw + tx) * k + dy * side + (2 * d - m)
    assert torch.equal(torch.sort(dst[keep]).values, torch.arange(th * tw * k))
    a[dst[keep]] = torch.where(ok, val, torch.zeros(()))[keep]
    return a.reshape(th, tw, k)


def emulate_bwd(f1, f2, g, plan):
    b, h, w, c = f1.shape
    d, th, tw = plan.d, plan.th, plan.tw
    side, rows, cols = 2 * d + 1, th + 2 * d, tw + 2 * d
    grads = [torch.full_like(f1, float("nan")) for _ in range(2)]
    for z in range(plan.grid[2]):
        bb, role = z >> 1, z & 1
        f = f1 if role else f2
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                y0, x0 = by * th, bx * tw
                a = _a_tile(g, bb, role, y0, x0, th, tw, d).double()
                for c0 in range(0, c, CHUNK):
                    v = _read(_stage(f, bb, c0, y0 - d, x0 - d, rows, cols), cols, rows).double()
                    acc = torch.zeros(th, tw, CHUNK, dtype=torch.float64)
                    for dy in range(side):
                        for dx in range(side):
                            acc += a[:, :, dy * side + dx, None] * v[dy:dy + th, dx:dx + tw]
                    hh, ww, cc = min(th, h - y0), min(tw, w - x0), min(CHUNK, c - c0)
                    grads[role][bb, y0:y0 + hh, x0:x0 + ww, c0:c0 + cc] = \
                        (acc.float() * (1.0 / c))[:hh, :ww, :cc]
    return grads


# shapes small enough to emulate tile by tile on the CPU: C = 3, 20, 32,
# 64 (two chunks), 81; d = 0 to 4; tiles and halos cut by every edge
_EMULATED = [(2, 9, 15, 32, 4), (1, 37, 61, 20, 4), (2, 5, 7, 3, 1), (1, 9, 15, 81, 0),
             (1, 18, 30, 64, 2), (1, 6, 40, 81, 3), (1, 1, 1, 32, 4), (2, 2, 33, 3, 4)]


def _inputs(shape):
    b, h, w, c, d = shape
    rng = np.random.RandomState(c * 7 + h + d)
    f1, f2 = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    return f1, f2, rng.randn(b, h, w, (2 * d + 1) ** 2).astype(np.float32)


def _close(out, ref, name):
    """tests/test_torch_autograd.py : _close."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(ref).max()), 1.0), err_msg=name)


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
@pytest.mark.parametrize("shape", _EMULATED)
def test_forward_arithmetic_matches_jax(shape, kw):
    f1, f2, _ = _inputs(shape)
    plan = correlation.correlation_plan(*shape, **kw)
    out = emulate_fwd(torch.from_numpy(f1), torch.from_numpy(f2), plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(correlation2d_ref(f1, f2, shape[-1])),
                               atol=1e-5)


@pytest.mark.parametrize("kw", _KW, ids=_IDS)
@pytest.mark.parametrize("shape", _EMULATED)
def test_backward_gather_matches_jax(shape, kw):
    f1, f2, g = _inputs(shape)
    plan = correlation.correlation_plan(*shape, backward=True, **kw)
    grads = emulate_bwd(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(g), plan)
    for name, got, ref in zip(("grad1", "grad2"), grads,
                              _correlation2d_bwd_ref(f1, f2, g, shape[-1])):
        _close(got, ref, name)


@pytest.mark.parametrize("shape", _EMULATED[:4])
def test_cpu_wrappers_match_jax(shape):
    """On CPU tensors the wrappers are the plain versions, held to JAX."""
    f1, f2, g = _inputs(shape)
    d = shape[-1]
    t = [torch.from_numpy(a) for a in (f1, f2, g)]
    np.testing.assert_allclose(correlation.correlation2d_fwd(t[0], t[1], d).numpy(),
                               np.asarray(correlation2d_ref(f1, f2, d)), atol=1e-5)
    for name, got, ref in zip(("grad1", "grad2"), correlation.correlation2d_bwd(*t, d),
                              _correlation2d_bwd_ref(f1, f2, g, d)):
        _close(got, ref, name)


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="max_displacement"):
        correlation.correlation_plan(1, 8, 8, 32, 5)
    for bad in (dict(tw=8), dict(th=5)):
        with pytest.raises(ValueError):
            correlation.correlation_plan(1, 8, 8, 32, 4, **bad)
    assert not correlation.CorrPlan(1, 8, 8, 32, 4, 4, 64, False).fits()
