"""Host-side flow warping + occlusion-mask utilities (numpy).

Mirrors reference utils.py:505-678: bidirectional-consistency occlusion
masks, backward scatter-map occlusion, and the numpy image warper used by
the Kubric raw pipeline.

Fidelity note: the reference's ``flow_warp`` normalizes pixel coords with
``2p/(W-1)-1`` but samples with ``align_corners=False`` (utils.py:519,531),
which effectively samples at ``p*W/(W-1) - 0.5``. ``_warp_bilinear_torchlike``
reproduces that exact (slightly off-grid) behavior so occlusion masks match.
"""

from __future__ import annotations

import numpy as np


def _warp_bilinear_torchlike(x: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp [H,W,C] by flow [H,W,2] with the reference's
    norm-then-align_corners=False semantics, zeros padding."""
    h, w, c = x.shape
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    px = gx + flow[..., 0]
    py = gy + flow[..., 1]
    # align_corners=False un-normalization of a (W-1)-normalized coordinate
    qx = px * w / (w - 1) - 0.5
    qy = py * h / (h - 1) - 0.5

    x0 = np.floor(qx).astype(np.int64)
    y0 = np.floor(qy).astype(np.int64)
    wx = (qx - x0).astype(np.float32)
    wy = (qy - y0).astype(np.float32)

    out = np.zeros((h, w, c), np.float32)
    flat = x.reshape(-1, c).astype(np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            weight = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            idx = np.clip(yi, 0, h - 1) * w + np.clip(xi, 0, w - 1)
            tap = flat[idx.reshape(-1)].reshape(h, w, c)
            out += tap * (weight * valid)[..., None]
    return out


def get_occu_mask_bidirection(flow12: np.ndarray, flow21: np.ndarray,
                              scale: float = 0.01, bias: float = 0.5) -> np.ndarray:
    """Forward-backward consistency occlusion (reference utils.py:535-553).

    Returns a float map: 1.0 where occluded. flow12/flow21 are [H, W, 2].
    """
    assert flow12.shape[2] == 2
    flow21_warped = _warp_bilinear_torchlike(flow21.astype(np.float32), flow12)
    diff = flow12 + flow21_warped
    mag = (flow12 ** 2).sum(-1) + (flow21_warped ** 2).sum(-1)
    occ = (diff ** 2).sum(-1) > (scale * mag + bias)
    return occ.astype(np.float32)


def get_occu_mask_backward(flow21: np.ndarray, th: float = 0.2) -> np.ndarray:
    """Backward scatter-map occlusion (reference utils.py:556-621).

    flow21 [H, W, 2] -> float map, 1.0 where (almost) nothing maps there.
    """
    h, w = flow21.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    x = (gx + flow21[..., 0]).reshape(-1)
    y = (gy + flow21[..., 1]).reshape(-1)

    corr = np.zeros(h * w, np.float32)
    x1, y1 = np.floor(x), np.floor(y)
    for xi, yi in [(x1 + 1, y1 + 1), (x1 + 1, y1), (x1, y1 + 1), (x1, y1)]:
        xc = np.clip(xi, 0, w - 1)
        yc = np.clip(yi, 0, h - 1)
        invalid = (xi != xc) | (yi != yc)
        vals = (1 - np.abs(x - xi)) * (1 - np.abs(y - yi))
        vals = np.where(invalid, 0.0, vals).astype(np.float32)
        np.add.at(corr, (xc + yc * w).astype(np.int64), vals)
    occ = np.clip(corr.reshape(h, w), 0.0, 1.0) < th
    return occ.astype(np.float32)


def flow_warp_numpy(img: np.ndarray, flow: np.ndarray, filling_value=0,
                    interpolate_mode: str = "nearest") -> np.ndarray:
    """Warp ``img [H,W,C]`` by ``flow [H,W,2]`` (reference utils.py:624-678).

    Note the reference's (row, col) convention: dx is the row coordinate
    displaced by flow's y component.
    """
    assert flow.ndim == 3
    h, w = flow.shape[:2]
    c = img.shape[2]
    out = np.ones((h, w, c), dtype=img.dtype) * filling_value

    grid = np.indices((h, w)).swapaxes(0, 1).swapaxes(1, 2)
    dx = grid[:, :, 0] + flow[:, :, 1]   # row position
    dy = grid[:, :, 1] + flow[:, :, 0]   # col position
    sx = np.floor(dx).astype(int)
    sy = np.floor(dy).astype(int)
    valid = (sx >= 0) & (sx < h - 1) & (sy >= 0) & (sy < w - 1)

    if interpolate_mode == "nearest":
        out[valid, :] = img[dx[valid].round().astype(int),
                            dy[valid].round().astype(int), :]
    elif interpolate_mode == "bilinear":
        eps = 1e-6
        dx, dy = dx + eps, dy + eps
        dxv, dyv = dx[valid], dy[valid]
        lt = img[np.floor(dxv).astype(int), np.floor(dyv).astype(int), :] * (
            (np.ceil(dxv) - dxv)[:, None] * (np.ceil(dyv) - dyv)[:, None])
        ld = img[np.ceil(dxv).astype(int), np.floor(dyv).astype(int), :] * (
            (dxv - np.floor(dxv))[:, None] * (np.ceil(dyv) - dyv)[:, None])
        rt = img[np.floor(dxv).astype(int), np.ceil(dyv).astype(int), :] * (
            (np.ceil(dxv) - dxv)[:, None] * (dyv - np.floor(dyv))[:, None])
        rd = img[np.ceil(dxv).astype(int), np.ceil(dyv).astype(int), :] * (
            (dxv - np.floor(dxv))[:, None] * (dyv - np.floor(dyv))[:, None])
        out[valid, :] = lt + ld + rt + rd
    else:
        raise NotImplementedError(interpolate_mode)
    return out.astype(img.dtype)
