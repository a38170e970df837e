"""Flow / event visualization (host-side numpy; counterpart of
rpeflow_tpu/utils/visualization.py, whose functions it keeps, name for name).

Mirrors the visualization half of reference utils.py:266-402 (Middlebury
color-wheel optical-flow rendering) and event_utils.py:306-448 (event-voxel
previews): the standard Baker et al. color wheel with 55 hue bins. The file
writers import ``imageio`` (else ``cv2``) when called.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """Standard 55-entry Middlebury color wheel, [55, 3] uint8-range floats."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """Render ``[H, W, 2]`` optical flow as an RGB uint8 image."""
    flow = np.nan_to_num(np.asarray(flow, np.float32), nan=0.0,
                         posinf=0.0, neginf=0.0)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_flow is None:
        max_flow = max(np.max(rad), 1e-5)
    u = u / max_flow
    v = v / max_flow
    rad = np.sqrt(u ** 2 + v ** 2)

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img


def scene_flow_to_image(flow_3d: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """Render per-point scene flow ``[N, 3]`` as RGB colors ``[N, 3]`` uint8.

    Each axis is mapped to a channel around gray, like the reference's
    3D-flow visualizations.
    """
    if max_flow is None:
        max_flow = max(float(np.abs(flow_3d).max()), 1e-5)
    norm = np.clip(flow_3d / max_flow, -1, 1)
    return ((norm * 0.5 + 0.5) * 255).astype(np.uint8)


def event_voxel_to_image(event_voxel: np.ndarray) -> np.ndarray:
    """Render an event voxel ``[H, W, C]`` as an RGB preview.

    Positive accumulation -> red, negative -> blue (event_utils.py:306-448
    renders the same polarity split).
    """
    half = event_voxel.shape[-1] // 2
    if half > 0:
        pos = event_voxel[..., :half].sum(-1)
        neg = event_voxel[..., half:].sum(-1)
        signed = pos - neg
    else:
        signed = event_voxel.sum(-1)
    mx = max(float(np.abs(signed).max()), 1e-5)
    signed = signed / mx
    img = np.full(signed.shape + (3,), 255, np.uint8)
    img[..., 1] = (255 * (1 - np.abs(signed))).astype(np.uint8)
    img[..., 0] = np.where(signed < 0, (255 * (1 - np.abs(signed))), 255).astype(np.uint8)
    img[..., 2] = np.where(signed > 0, (255 * (1 - np.abs(signed))), 255).astype(np.uint8)
    return img


# ---------------------------------------------------------------------------
# Per-event renders + file writers (reference event_utils.py:306-448).
# All functions take the repo's [N, 4] float32 (x, y, t, p) event format
# (data/event_voxel.py:load_events_h5) and return RGB uint8 images.
# ---------------------------------------------------------------------------

def _events_xyp(events: np.ndarray):
    ex = events[:, 0].astype(np.int32)
    ey = events[:, 1].astype(np.int32)
    ep = events[:, 3].astype(np.int32)
    return ex, ey, ep


def events_to_grey_image(events: np.ndarray) -> np.ndarray:
    """Count-accumulation greyscale render (event_utils.py:324-341).

    Reproduces the reference's display normalization (x1e4 count scaling
    clipped to uint8 — all but the emptiest pixels saturate, which is the
    intended "activity mask" look).
    """
    ex, ey, ep = _events_xyp(events)
    width = int(ex.max()) + 1
    height = int(ey.max()) + 1
    mask = (ex < width - 1) & (ey < height - 1) & (ex >= 0) & (ey >= 0)
    coords = np.stack((ey * mask, ex * mask))
    abs_coords = np.ravel_multi_index(coords, [height, width])
    img = np.bincount(abs_coords, minlength=height * width) \
        .reshape(height, width).astype(np.float32)
    return np.clip((10000 * img / (img.max() - img.min() + 1e-5)),
                   0, 255).astype(np.uint8)


def events_to_color_image(events: np.ndarray,
                          background: str = "black") -> np.ndarray:
    """Polarity-colored binary render (event_utils.py:343-362): positive
    events blue, negative red, over a black or white background. RGB
    channel order (the reference builds the same image in cv2's BGR)."""
    ex, ey, ep = _events_xyp(events)
    width = int(ex.max()) + 1
    height = int(ey.max()) + 1
    if background == "black":
        img = np.zeros((height, width, 3), np.uint8)
    else:
        img = np.ones((height, width, 3), np.uint8)
    pos = ep > 0
    neg = ~pos
    img[ey[pos], ex[pos]] = [0, 0, 1]   # positive -> blue
    img[ey[neg], ex[neg]] = [1, 0, 0]   # negative -> red
    return img * 255


def _imwrite(filename: str, img_rgb: np.ndarray) -> None:
    try:
        import imageio.v2 as imageio

        imageio.imwrite(filename, img_rgb)
    except ImportError:
        import cv2

        cv2.imwrite(filename, img_rgb[..., ::-1] if img_rgb.ndim == 3
                    else img_rgb)


def write_event_voxel_preview(filename: str, event_voxel: np.ndarray) -> None:
    """File writer for the voxel preview (event_utils.py:417-422).
    ``event_voxel`` is channels-last [H, W, C]."""
    _imwrite(filename, event_voxel_to_image(np.asarray(event_voxel)))


def write_events_voxel_preview(filename: str, events: np.ndarray,
                               num_bins: int = 5) -> None:
    """Voxelize a raw event stream, then write its preview
    (event_utils.py:425-430)."""
    from ..data.event_voxel import events_to_voxel

    ex = np.asarray(events)
    h = int(ex[:, 1].max()) + 1
    w = int(ex[:, 0].max()) + 1
    voxel = events_to_voxel(ex, num_bins, h, w, event_polarity=False)
    _imwrite(filename, event_voxel_to_image(voxel))


def write_events_grey(filename: str, events: np.ndarray) -> None:
    """Greyscale activity render writer (event_utils.py:433-438)."""
    _imwrite(filename, events_to_grey_image(np.asarray(events)))


def write_events_color(filename: str, events: np.ndarray,
                       center_crop=None) -> None:
    """Polarity-colored render writer with optional center crop
    (event_utils.py:441-448)."""
    img = events_to_color_image(np.asarray(events), background="white")
    if center_crop is not None:
        height, width, _ = img.shape
        ch, cw = center_crop
        y0 = (height - ch) // 2
        x0 = (width - cw) // 2
        img = img[y0:y0 + ch, x0:x0 + cw]
    _imwrite(filename, img)
