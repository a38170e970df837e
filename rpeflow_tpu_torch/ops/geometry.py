"""Camera projection and the inverse-depth-scaled (IDS) point transforms
(counterpart of rpeflow_tpu/ops/geometry.py). Points ``[B, N, 3]``, pixel
coordinates ``[B, N, 2]`` with last dim (x, y).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .gather import batch_gather
from .sample import grid_sample_2d, mesh_grid


class CameraInfo(NamedTuple):
    """``projection_mode`` is 'perspective' or 'parallel'; sensor sizes are
    ints; f, cx, cy are ``[B]`` tensors or python floats (f unused when
    parallel)."""

    projection_mode: str
    sensor_h: int
    sensor_w: int
    f: Optional[torch.Tensor]
    cx: Union[torch.Tensor, float]
    cy: Union[torch.Tensor, float]


def _expand(v, like: torch.Tensor):
    if isinstance(v, (int, float)):
        return float(v)
    return v.to(like.dtype)[:, None]


def project_pc2image(pc: torch.Tensor, camera: CameraInfo) -> torch.Tensor:
    """``[B, N, 3]`` points -> ``[B, N, 2]`` pixel coordinates."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    cx = _expand(camera.cx, x)
    cy = _expand(camera.cy, y)
    if camera.projection_mode == "perspective":
        f = _expand(camera.f, x)
        ix = cx + (f / z) * x
        iy = cy + (f / z) * y
    elif camera.projection_mode == "parallel":
        ix = x + cx
        iy = y + cy
    else:
        raise NotImplementedError(camera.projection_mode)
    return torch.stack([ix, iy], dim=-1)


def perspect2parallel(xyz: torch.Tensor, persp: CameraInfo,
                      paral: CameraInfo) -> torch.Tensor:
    """Perspective -> inverse-depth-scaled parallel camera space."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    f = _expand(persp.f, x)
    cx = _expand(persp.cx, x)
    cy = _expand(persp.cy, y)
    dx = cx + (f / z) * x
    dy = cy + (f / z) * y
    dz = f * torch.log(z) + 1.0
    srw = (paral.sensor_w - 1) / (persp.sensor_w - 1)
    srh = (paral.sensor_h - 1) / (persp.sensor_h - 1)
    return torch.stack([dx * srw - (paral.sensor_w - 1) / 2,
                        dy * srh - (paral.sensor_h - 1) / 2,
                        dz * min(srw, srh)], dim=-1)


def parallel2perspect(xyz: torch.Tensor, persp: CameraInfo,
                      paral: CameraInfo) -> torch.Tensor:
    """Inverse of :func:`perspect2parallel`."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    srw = (paral.sensor_w - 1) / (persp.sensor_w - 1)
    srh = (paral.sensor_h - 1) / (persp.sensor_h - 1)
    x = (x + (paral.sensor_w - 1) / 2) / srw
    y = (y + (paral.sensor_h - 1) / 2) / srh
    z = z / min(srw, srh)
    f = _expand(persp.f, x)
    cx = _expand(persp.cx, x)
    cy = _expand(persp.cy, y)
    dz = torch.exp((z - 1.0) / f)
    dx = (x - cx) * dz / f
    dy = (y - cy) * dz / f
    return torch.stack([dx, dy, dz], dim=-1)


def project_feat_with_nn_corr(xy: torch.Tensor, feat_2d: torch.Tensor,
                              feat_3d: torch.Tensor,
                              nn_indices: torch.Tensor) -> torch.Tensor:
    """Splat point features onto the pixel grid through each pixel's nearest
    projected point: ``[B, H, W, 3 + C3]`` with channels (offset_x, offset_y,
    corr, feat_3d). ``nn_indices [B, H*W]``. No gradient flows through it
    (the reference's ``@torch.no_grad``, the JAX ``stop_gradient``)."""
    xy, feat_2d, feat_3d = xy.detach(), feat_2d.detach(), feat_3d.detach()
    b, h, w, c2 = feat_2d.shape
    grid = mesh_grid(h, w, device=feat_2d.device).reshape(1, h * w, 2)
    point_feat2d = grid_sample_2d(feat_2d, xy, "zeros")
    table = torch.cat([xy, point_feat2d.float(), feat_3d.float()], dim=-1)
    nn = batch_gather(table, nn_indices)
    nn_offset = nn[..., :2] - grid
    nn_feat2d = nn[..., 2:2 + c2].to(feat_2d.dtype)
    nn_feat3d = nn[..., 2 + c2:].to(feat_3d.dtype)
    nn_corr = (nn_feat2d * feat_2d.reshape(b, h * w, c2)).mean(-1, keepdim=True)
    out = torch.cat([nn_offset.to(feat_2d.dtype), nn_corr, nn_feat3d], dim=-1)
    return out.reshape(b, h, w, 3 + feat_3d.shape[-1])

