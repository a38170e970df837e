"""The port's plain ops against rpeflow_tpu.ops on the same numpy inputs:
knn, gather, bilinear sampling (both padding modes), interpolation and
camera geometry. Tolerance atol 1e-5 (float32 sum-order noise) unless
stated; KNN with k > 1 is compared as neighbour sets, allowing 0.5% of
queries to swap an exactly tied neighbour.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpeflow_tpu import ops as jops
from rpeflow_tpu_torch import ops

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol, rtol=1e-5)


def _cams(rng, b, h, w):
    intr = np.stack([rng.uniform(40, 60, b), np.full(b, (w - 1) / 2), np.full(b, (h - 1) / 2)],
                    1).astype(np.float32)
    jp = jops.CameraInfo("perspective", h, w, jnp.asarray(intr[:, 0]), jnp.asarray(intr[:, 1]),
                         jnp.asarray(intr[:, 2]))
    tp = ops.CameraInfo("perspective", h, w, _t(intr[:, 0]), _t(intr[:, 1]), _t(intr[:, 2]))
    ph, pw = 4, 6
    jq = jops.CameraInfo("parallel", ph, pw, None, (pw - 1) / 2, (ph - 1) / 2)
    tq = ops.CameraInfo("parallel", ph, pw, None, (pw - 1) / 2, (ph - 1) / 2)
    return (jp, tp), (jq, tq)


def _points(rng, b, n):
    xyz = rng.randn(b, n, 3).astype(np.float32)
    xyz[..., 2] = rng.uniform(2, 20, (b, n))
    return xyz


def test_squared_distance(rng):
    a, b = rng.randn(2, 50, 3).astype(np.float32), rng.randn(2, 70, 3).astype(np.float32)
    _close(ops.squared_distance(_t(a), _t(b)), jops.squared_distance(a, b), atol=1e-4)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_matches_jax(rng, k):
    inp = rng.rand(2, 200, 3).astype(np.float32) * 10
    qry = rng.rand(2, 150, 3).astype(np.float32) * 10
    out = ops.k_nearest_neighbor(_t(inp), _t(qry), k).numpy()
    ref = np.asarray(jops.k_nearest_neighbor(inp, qry, k))
    assert out.shape == ref.shape == (2, 150, k)
    if k == 1:
        np.testing.assert_array_equal(out, ref)
    else:
        same = np.mean([set(o) == set(r) for o, r in zip(out.reshape(-1, k), ref.reshape(-1, k))])
        assert same >= 0.995, f"only {same:.2%} of neighbour sets agree"


def test_knn_chunked_matches_unchunked(rng, monkeypatch):
    """The query-axis chunking is invisible in the result."""
    from rpeflow_tpu_torch.ops import knn

    inp = _t(rng.rand(2, 300, 2).astype(np.float32) * 20)
    qry = _t(rng.rand(2, 1000, 2).astype(np.float32) * 20)
    whole = knn.k_nearest_neighbor(inp, qry, 1)
    monkeypatch.setattr(knn, "CHUNK_BUDGET_ELEMS", 2 * 250 * 300)
    assert knn._pick_chunk(1000, 300, 2) == 250
    np.testing.assert_array_equal(knn.k_nearest_neighbor(inp, qry, 1).numpy(), whole.numpy())


@pytest.mark.parametrize("c", [None, 5])
def test_batch_gather(rng, c):
    data = rng.randn(2, 40, c).astype(np.float32) if c else rng.randn(2, 40).astype(np.float32)
    idx = rng.randint(0, 40, (2, 7, 3)).astype(np.int32)
    np.testing.assert_array_equal(ops.batch_gather(_t(data), _t(idx)).numpy(),
                                  np.asarray(jops.batch_gather(data, idx)))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample(rng, mode):
    feat = rng.randn(2, 9, 13, 4).astype(np.float32)
    xy = np.stack([rng.uniform(-3, 15, (2, 60)), rng.uniform(-3, 11, (2, 60))], -1)
    xy = xy.astype(np.float32)
    xy[0, :4] = [[0, 0], [12, 8], [12, 0], [3.5, 8]]  # exact borders
    _close(ops.grid_sample_2d(_t(feat), _t(xy), mode),
           jops.grid_sample_2d(feat, xy, padding_mode=mode))


def test_backwarp_2d(rng):
    feat = rng.randn(2, 10, 12, 3).astype(np.float32)
    flow = (rng.randn(2, 10, 12, 2) * 3).astype(np.float32)
    _close(ops.backwarp_2d(_t(feat), _t(flow), "border"), jops.backwarp_2d(feat, flow, "border"))


@pytest.mark.parametrize("out_hw", [(20, 30), (7, 5), (1, 9)])
def test_resize_bilinear_ac(rng, out_hw):
    x = rng.randn(2, 9, 15, 3).astype(np.float32)
    _close(ops.resize_bilinear_ac(_t(x), *out_hw), jops.resize_bilinear_ac(x, *out_hw))


def test_resize_flow2d_and_64x(rng):
    flow = rng.randn(1, 18, 30, 2).astype(np.float32)
    _close(ops.resize_flow2d(_t(flow), 36, 64), jops.resize_flow2d(flow, 36, 64))
    img = rng.rand(1, 50, 70, 3).astype(np.float32)
    out = ops.resize_to_64x(_t(img))
    assert tuple(out.shape) == (1, 64, 128, 3)
    _close(out, jops.resize_to_64x(img))


def test_knn_interpolation_and_backwarp_3d(rng):
    xyz_in, xyz_q = _points(rng, 2, 80), _points(rng, 2, 50)
    feat = rng.randn(2, 80, 6).astype(np.float32)
    _close(ops.knn_interpolation(_t(xyz_in), _t(feat), _t(xyz_q)),
           jops.knn_interpolation(xyz_in, feat, xyz_q), atol=1e-4)
    xyz2 = _points(rng, 2, 80)
    flow = (rng.randn(2, 80, 3) * 0.1).astype(np.float32)
    _close(ops.backwarp_3d(_t(xyz_in), _t(xyz2), _t(flow)),
           jops.backwarp_3d(xyz_in, xyz2, flow), atol=1e-4)


def test_convex_upsample(rng):
    flow = rng.randn(2, 6, 7, 2).astype(np.float32)
    mask = rng.randn(2, 6, 7, 144).astype(np.float32)
    _close(ops.convex_upsample(_t(flow), _t(mask), 4),
           jops.convex_upsample(flow, mask, 4, use_d2s_conv=False))


def test_projection_and_ids_roundtrip(rng):
    (jp, tp), (jq, tq) = _cams(rng, 2, 64, 96)
    xyz = _points(rng, 2, 100)
    _close(ops.project_pc2image(_t(xyz), tp), jops.project_pc2image(xyz, jp), atol=1e-4)
    par = ops.perspect2parallel(_t(xyz), tp, tq)
    _close(par, jops.perspect2parallel(xyz, jp, jq), atol=1e-4)
    _close(ops.project_pc2image(par, tq), jops.project_pc2image(np.asarray(par), jq))
    back = ops.parallel2perspect(par, tp, tq)
    _close(back, jops.parallel2perspect(np.asarray(par), jp, jq), atol=1e-4)
    _close(back, xyz, atol=1e-3)


def test_project_feat_with_nn_corr(rng):
    b, h, w = 2, 8, 12
    xy = np.stack([rng.uniform(0, w - 1, (b, 30)), rng.uniform(0, h - 1, (b, 30))], -1)
    xy = xy.astype(np.float32)
    f2d = rng.randn(b, h, w, 5).astype(np.float32)
    f3d = rng.randn(b, 30, 7).astype(np.float32)
    nn_idx = rng.randint(0, 30, (b, h * w)).astype(np.int32)
    _close(ops.project_feat_with_nn_corr(_t(xy), _t(f2d), _t(f3d), _t(nn_idx)),
           jops.project_feat_with_nn_corr(xy, f2d, f3d, nn_idx))
