"""Geometry-consistent joint augmentation (host-side numpy).

Mirrors reference augmentation.py:7-267: color jitter, horizontal/vertical
flips that re-project the point clouds through the camera, window crops that
re-center the principal point and drop out-of-window points, and
crop-then-resize scaling with sparse-flow re-rasterization.

The color jitter is a numpy re-implementation of torchvision ColorJitter
semantics (random order of brightness/contrast/saturation/hue with uniform
factors), applied identically to both frames as upstream does.

The port's copy of ``rpeflow_tpu/data/augmentation.py``, with ``cv2``
imported inside the functions that use it.
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# color jitter
# --------------------------------------------------------------------------

def _blend(a, b, alpha):
    return np.clip(alpha * a + (1 - alpha) * b, 0, 255)


def _adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def _adjust_contrast(img, factor):
    import cv2

    gray = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2GRAY).mean()
    return _blend(img, np.full_like(img, gray), factor)


def _adjust_saturation(img, factor):
    import cv2

    gray = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2GRAY)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def _adjust_hue(img, factor):
    import cv2

    hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int32)
    hsv[..., 0] = ((h + int(factor * 180)) % 180).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


def color_jitter(image1, image2, brightness, contrast, saturation, hue):
    """Identical random photometric jitter on both frames."""
    ops = []
    if brightness:
        ops.append(("b", np.random.uniform(max(0, 1 - brightness), 1 + brightness)))
    if contrast:
        ops.append(("c", np.random.uniform(max(0, 1 - contrast), 1 + contrast)))
    if saturation:
        ops.append(("s", np.random.uniform(max(0, 1 - saturation), 1 + saturation)))
    if hue:
        ops.append(("h", np.random.uniform(-hue, hue)))
    np.random.shuffle(ops)

    def apply(img):
        img = img.astype(np.float32)
        for kind, factor in ops:
            if kind == "b":
                img = _adjust_brightness(img, factor)
            elif kind == "c":
                img = _adjust_contrast(img, factor)
            elif kind == "s":
                img = _adjust_saturation(img, factor)
            else:
                img = _adjust_hue(img, factor)
        return img.astype(np.uint8)

    return apply(image1), apply(image2)


# --------------------------------------------------------------------------
# flips
# --------------------------------------------------------------------------

def flip_point_cloud(pc, image_h, image_w, f, cx, cy, flip_mode):
    """Mirror a cloud through the camera (reference augmentation.py:20-36)."""
    assert flip_mode in ("lr", "ud")
    x, y, depth = pc[..., 0], pc[..., 1], pc[..., 2]
    ix = cx + (f / depth) * x
    iy = cy + (f / depth) * y
    if flip_mode == "lr":
        ix = image_w - 1 - ix
    else:
        iy = image_h - 1 - iy
    x = (ix - cx) * depth / f
    y = (iy - cy) * depth / f
    return np.stack([x, y, depth], axis=-1)


def flip_scene_flow(pc1, flow_3d, image_h, image_w, f, cx, cy, flip_mode):
    new_pc1 = flip_point_cloud(pc1, image_h, image_w, f, cx, cy, flip_mode)
    new_pc1_warp = flip_point_cloud(pc1 + flow_3d[:, :3], image_h, image_w,
                                    f, cx, cy, flip_mode)
    return np.concatenate([new_pc1_warp - new_pc1, flow_3d[:, 3:]], axis=-1)


def flip_image(image, flip_mode):
    return (np.fliplr(image) if flip_mode == "lr" else np.flipud(image)).copy()


def flip_optical_flow(flow, flip_mode):
    if flip_mode == "lr":
        flow = np.fliplr(flow).copy()
        flow[:, :, 0] *= -1
    else:
        flow = np.flipud(flow).copy()
        flow[:, :, 1] *= -1
    return flow


def random_flip(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                flip_mode, event=None):
    """50%-probability joint flip (reference augmentation.py:63-88)."""
    assert flow_3d.shape[1] <= 4
    image_h, image_w = image1.shape[:2]
    if np.random.rand() < 0.5:
        return image1, image2, pc1, pc2, flow_2d, flow_3d, event

    image1 = flip_image(image1, flip_mode)
    image2 = flip_image(image2, flip_mode)
    new_pc1 = flip_point_cloud(pc1, image_h, image_w, f, cx, cy, flip_mode)
    new_pc2 = flip_point_cloud(pc2, image_h, image_w, f, cx, cy, flip_mode)
    new_flow_2d = flip_optical_flow(flow_2d, flip_mode)
    new_flow_3d = flip_scene_flow(pc1, flow_3d, image_h, image_w, f, cx, cy, flip_mode)
    if event is not None:
        event = flip_image(event, flip_mode)
    return image1, image2, new_pc1, new_pc2, new_flow_2d, new_flow_3d, event


# --------------------------------------------------------------------------
# crops / scaling
# --------------------------------------------------------------------------

def crop_image_with_pc(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                       crop_window, event=None):
    """Window crop with principal-point shift (reference augmentation.py:91-133)."""
    x1, y1, x2, y2 = crop_window
    image_h, image_w = image1.shape[:2]
    cx = (image_w - 1) / 2 if cx is None else cx
    cy = (image_h - 1) / 2 if cy is None else cy

    xy1x = cx + (f / pc1[..., 2]) * pc1[..., 0]
    xy1y = cy + (f / pc1[..., 2]) * pc1[..., 1]
    xy2x = cx + (f / pc2[..., 2]) * pc2[..., 0]
    xy2y = cy + (f / pc2[..., 2]) * pc2[..., 1]

    image1 = image1[y1:y2, x1:x2].copy()
    image2 = image2[y1:y2, x1:x2].copy()
    flow_2d = flow_2d[y1:y2, x1:x2].copy()
    if event is not None:
        event = event[y1:y2, x1:x2].copy()

    m1 = (xy1x > x1) & (xy1x < x2) & (xy1y > y1) & (xy1y < y2)
    m2 = (xy2x > x1) & (xy2x < x2) & (xy2y > y1) & (xy2y < y2)
    pc1, pc2, flow_3d = pc1[m1], pc2[m2], flow_3d[m1]

    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx - x1, cy - y1, event


def random_crop(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                crop_size, event=None):
    crop_w, crop_h = crop_size
    image_h, image_w = image1.shape[:2]
    assert crop_w <= image_w and crop_h <= image_h
    x1 = np.random.randint(0, image_w - crop_w + 1)
    y1 = np.random.randint(0, image_h - crop_h + 1)
    return crop_image_with_pc(image1, image2, pc1, pc2, flow_2d, flow_3d,
                              f, cx, cy, [x1, y1, x1 + crop_w, y1 + crop_h],
                              event=event)


def resize_sparse_flow_map(flow, target_w, target_h):
    """Re-rasterize a sparse (masked) flow map (reference augmentation.py:152-176)."""
    curr_h, curr_w = flow.shape[:2]
    coords = np.stack(np.meshgrid(np.arange(curr_w), np.arange(curr_h)),
                      axis=-1).astype(np.float32)
    mask = flow[..., -1] > 0
    coords0, flow0 = coords[mask], flow[mask][:, :2]

    srw = (target_w - 1) / (curr_w - 1)
    srh = (target_h - 1) / (curr_h - 1)
    coords1 = coords0 * [srw, srh]
    flow1 = flow0 * [srw, srh]

    xx = np.round(coords1[:, 0]).astype(np.int32)
    yy = np.round(coords1[:, 1]).astype(np.int32)
    valid = (xx >= 0) & (xx < target_w) & (yy >= 0) & (yy < target_h)
    xx, yy, flow1 = xx[valid], yy[valid], flow1[valid]

    out = np.zeros([target_h, target_w, 3], np.float32)
    out[yy, xx, :2] = flow1
    out[yy, xx, 2:] = 1.0
    return out


def random_scale(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                 scale_range, event=None):
    """Crop-then-resize zoom (reference augmentation.py:179-223)."""
    import cv2

    assert 1 <= scale_range[0] < scale_range[1]
    if np.random.rand() < 0.5:
        return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event

    ratio = np.random.uniform(scale_range[0], scale_range[1])
    image_h, image_w = image1.shape[:2]
    crop_h, crop_w = int(image_h / ratio), int(image_w / ratio)
    x1 = np.random.randint(0, image_w - crop_w + 1)
    y1 = np.random.randint(0, image_h - crop_h + 1)

    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event = \
        crop_image_with_pc(image1, image2, pc1, pc2, flow_2d, flow_3d,
                           f, cx, cy, [x1, y1, x1 + crop_w, y1 + crop_h],
                           event=event)

    image1 = cv2.resize(image1, (image_w, image_h), interpolation=cv2.INTER_LINEAR)
    image2 = cv2.resize(image2, (image_w, image_h), interpolation=cv2.INTER_LINEAR)
    flow_2d = resize_sparse_flow_map(flow_2d, image_w, image_h)

    srw = (image_w - 1) / (crop_w - 1)
    srh = (image_h - 1) / (crop_h - 1)
    pc1 = pc1.copy()
    pc2 = pc2.copy()
    flow_3d = flow_3d.copy()
    pc1[:, 0] *= srw
    pc1[:, 1] *= srh
    pc2[:, 0] *= srw
    pc2[:, 1] *= srh
    flow_3d[:, 0] *= srw
    flow_3d[:, 1] *= srh
    cx *= srw
    cy *= srh
    if event is not None:
        event = cv2.resize(event, (image_w, image_h), interpolation=cv2.INTER_LINEAR)
    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event


def joint_augmentation(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                       cfgs, event=None):
    """Config-driven augmentation dispatcher (reference augmentation.py:226-267)."""
    if not cfgs.enabled:
        return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event

    if cfgs.color_jitter.enabled:
        image1, image2 = color_jitter(
            image1, image2,
            brightness=cfgs.color_jitter.brightness,
            contrast=cfgs.color_jitter.contrast,
            saturation=cfgs.color_jitter.saturation,
            hue=cfgs.color_jitter.hue)

    if cfgs.random_horizontal_flip.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, event = random_flip(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, "lr", event)

    if cfgs.random_vertical_flip.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, event = random_flip(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, "ud", event)

    if cfgs.random_crop.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event = \
            random_crop(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                        cfgs.random_crop.crop_size, event)

    if cfgs.random_scale.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event = \
            random_scale(image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
                         cfgs.random_scale.scale_range, event)

    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event
