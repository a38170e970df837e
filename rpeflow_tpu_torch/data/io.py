"""Host-side file I/O: flow / disparity / pfm readers+writers, depth->cloud
lifting.

Mirrors the I/O half of reference utils.py:57-263 (tiff/pfm/flo/16-bit-PNG
flow and disparity codecs, disp2pc/depth2pc, numpy projection).

The port's copy of ``rpeflow_tpu/data/io.py``, with ``cv2`` imported inside
the functions that use it.
"""

from __future__ import annotations

import re

import numpy as np


def load_tiff(path: str) -> np.ndarray:
    import imageio

    img = imageio.imread(path)
    assert img.ndim == 2
    return img


def load_pfm(path: str) -> np.ndarray:
    """Read a PFM file (reference utils.py:63-90)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape))


def load_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader (reference utils.py:93-101)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        assert magic == 202021.25, "Invalid .flo file"
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        return np.fromfile(f, np.float32, count=2 * w * h).reshape([h, w, 2])


def save_flo(path: str, flow: np.ndarray) -> None:
    assert flow.shape[2] == 2
    with open(path, "wb") as f:
        f.write(np.array(202021.25, np.float32).tobytes())
        f.write(np.array(flow.shape[1], np.int32).tobytes())
        f.write(np.array(flow.shape[0], np.int32).tobytes())
        f.write(flow.astype(np.float32).tobytes())


def load_flow_png(path: str, scale: float = 64.0):
    """KITTI-style 16-bit PNG flow (reference utils.py:104-114).

    Returns (flow [H,W,2] float32, valid mask [H,W] bool).
    """
    import cv2

    flow_img = cv2.imread(path, -1)
    flow = flow_img[:, :, 2:0:-1].astype(np.float32)
    mask = flow_img[:, :, 0] > 0
    return (flow - 32768.0) / scale, mask


def save_flow_png(path: str, flow: np.ndarray, mask=None, scale: float = 64.0) -> None:
    import cv2

    assert flow.shape[2] == 2
    assert np.abs(flow).max() < 32767.0 / scale
    flow = flow * scale + 32768.0
    if mask is None:
        mask = np.ones_like(flow)[..., 0]
    else:
        mask = np.float32(mask > 0)
    flow_img = np.concatenate(
        [mask[..., None], flow[..., 1:2], flow[..., 0:1]], axis=-1
    ).astype(np.uint16)
    cv2.imwrite(path, flow_img)


def load_disp_png(path: str):
    """KITTI 16-bit disparity PNG (reference utils.py:149-154)."""
    import cv2

    arr = cv2.imread(path, -1)
    valid = arr > 0
    disp = arr.astype(np.float32) / 256.0
    disp[~valid] = -1.0
    return disp, valid


def save_disp_png(path: str, disp: np.ndarray, mask=None) -> None:
    import cv2

    if mask is None:
        mask = disp > 0
    out = np.uint16(disp * 256.0)
    out[~mask] = 0
    cv2.imwrite(path, out)


def disp2pc(disp, baseline, f, cx, cy, flow=None) -> np.ndarray:
    """Disparity map -> point cloud [H, W, 3] (reference utils.py:200-220)."""
    h, w = disp.shape
    depth = baseline * f / (disp + 1e-5)
    return depth2pc(depth, f, cx, cy, flow)


def depth2pc(depth, f, cx, cy, flow=None) -> np.ndarray:
    """Depth map -> point cloud [H, W, 3] (reference utils.py:223-242)."""
    h, w = depth.shape
    xx = np.tile(np.arange(w, dtype=np.float32)[None, :], (h, 1))
    yy = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    if flow is None:
        x = (xx - cx) * depth / f
        y = (yy - cy) * depth / f
    else:
        x = (xx - cx + flow[..., 0]) * depth / f
        y = (yy - cy + flow[..., 1]) * depth / f
    return np.stack([x, y, depth], axis=-1)


def project_pc2image_np(pc, image_h, image_w, f, cx=None, cy=None, clip=True):
    """Numpy projection (reference utils.py:245-263); pc [N, 3] -> [N, 2]."""
    cx = (image_w - 1) / 2 if cx is None else cx
    cy = (image_h - 1) / 2 if cy is None else cy
    x = cx + (f / pc[..., 2]) * pc[..., 0]
    y = cy + (f / pc[..., 2]) * pc[..., 1]
    if clip:
        x = np.clip(x, 0, image_w - 1)
        y = np.clip(y, 0, image_h - 1)
    return np.stack([x, y], axis=-1)
