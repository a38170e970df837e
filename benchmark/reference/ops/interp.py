"""Resizing and interpolation with align_corners=True semantics (frozen copy
of rpeflow_tpu_torch/ops/interp.py). Channels-last throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from .gather import batch_gather_xyz_feat
from .knn import k_nearest_neighbor


def _ac_taps(n_in: int, n_out: int):
    """1-D align_corners taps (i0, i1, w1), computed in float64 as in JAX."""
    if n_out == 1:
        src = np.zeros((1,), np.float64)
    else:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, out_h, out_w, C]``, rows first then columns."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    dev, dt = x.device, x.dtype
    i0, i1, wy = _ac_taps(h, out_h)
    wy_t = torch.from_numpy(wy).to(dev, dt)[None, :, None, None]
    wy0 = torch.from_numpy(1.0 - wy).to(dev, dt)[None, :, None, None]
    x = x[:, torch.from_numpy(i0).to(dev)] * wy0 + x[:, torch.from_numpy(i1).to(dev)] * wy_t
    j0, j1, wx = _ac_taps(w, out_w)
    wx_t = torch.from_numpy(wx).to(dev, dt)[None, None, :, None]
    wx0 = torch.from_numpy(1.0 - wx).to(dev, dt)[None, None, :, None]
    return (x[:, :, torch.from_numpy(j0).to(dev)] * wx0
            + x[:, :, torch.from_numpy(j1).to(dev)] * wx_t)


def resize_flow2d(flow: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Resize a ``[B, H, W, 2]`` flow field and rescale its components."""
    h, w = flow.shape[1:3]
    if (h, w) == (target_h, target_w):
        return flow
    flow = resize_bilinear_ac(flow, target_h, target_w)
    scale = torch.tensor([target_w / w, target_h / h], dtype=flow.dtype, device=flow.device)
    return flow * scale


def resize_to_64x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear-resize ``[B, H, W, C]`` so H and W are multiples of 64."""
    h, w = x.shape[1:3]
    h64, w64 = -(-h // 64) * 64, -(-w // 64) * 64
    if (h64, w64) == (h, w):
        return x
    return resize_bilinear_ac(x, h64, w64)


def knn_interpolation(input_xyz: torch.Tensor, input_features: torch.Tensor,
                      query_xyz: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance-weighted k-NN interpolation -> ``[B, Q, C]``."""
    knn_idx = k_nearest_neighbor(input_xyz, query_xyz, k)
    knn_xyz, knn_feats = batch_gather_xyz_feat(input_xyz, input_features, knn_idx)
    diff = (knn_xyz - query_xyz[:, :, None, :]).float()
    dists = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-16))
    weights = 1.0 / dists
    weights = weights / weights.sum(-1, keepdim=True)
    return (knn_feats * weights[..., None].to(knn_feats.dtype)).sum(2)


def backwarp_3d(xyz1: torch.Tensor, xyz2: torch.Tensor, flow12: torch.Tensor,
                k: int = 3) -> torch.Tensor:
    """Warp ``xyz2`` backward through ``flow12`` living on ``xyz1``."""
    flow21 = knn_interpolation(xyz1 + flow12, -flow12, xyz2, k=k)
    return xyz2 + flow21


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    scale_factor: int = 4) -> torch.Tensor:
    """RAFT convex upsampling. ``flow [B, H, W, 2]``, ``mask [B, H, W, 9*s*s]``
    laid out (neighbour, sub_y, sub_x) -> ``[B, H*s, W*s, 2]``."""
    b, h, w, _ = flow.shape
    s = scale_factor
    m = torch.softmax(mask.reshape(b, h, w, 9, s * s).float(), dim=3)
    fp = torch.nn.functional.pad(flow.float() * s, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack([fp[:, di:di + h, dj:dj + w, :]
                        for di in range(3) for dj in range(3)], dim=3)  # [B,H,W,9,2]
    acc = torch.einsum("bhwnk,bhwnc->bhwkc", m, nbrs)
    acc = acc.reshape(b, h, w, s, s, 2).permute(0, 1, 3, 2, 4, 5)
    return acc.reshape(b, h * s, w * s, 2)
