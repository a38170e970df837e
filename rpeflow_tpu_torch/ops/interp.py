"""Resizing and interpolation with align_corners=True semantics (counterpart
of rpeflow_tpu/ops/interp.py). Channels-last throughout.

Values that depend only on shapes (the resize taps, the flow's rescale) are
built on the host once per shape, device and dtype and kept on the device
(:func:`device_constant`): a train step captured as a CUDA graph may copy
nothing from the host, and the eval forward saves the copies.
"""

from __future__ import annotations

import numpy as np
import torch

from .gather import batch_gather_xyz_feat
from .knn import k_nearest_neighbor


_CONSTANTS: dict = {}


def device_constant(key, make) -> torch.Tensor:
    """``make()``, built the first time ``key`` (which names what the value
    depends on: the shapes, the device, the dtype) is asked for, and kept.
    Built outside inference mode, so that a train step may save it for its
    backward after an eval forward built it."""
    value = _CONSTANTS.get(key)
    if value is None:
        with torch.inference_mode(False):
            value = _CONSTANTS[key] = make()
    return value


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


def ac_taps_on(n_in: int, n_out: int, device, dtype):
    """:func:`_ac_taps` on ``device``: ``(i0, i1, w1, 1 - w1)``, the indices
    as int64, the weights in ``dtype``."""
    def make():
        i0, i1, w1 = _ac_taps(n_in, n_out)
        return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
                torch.from_numpy(w1).to(device, dtype),
                torch.from_numpy(1.0 - w1).to(device, dtype))
    return device_constant(("ac_taps", n_in, n_out, device, dtype), make)


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, out_h, out_w, C]``, rows first then columns."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    i0, i1, wy, wy0 = ac_taps_on(h, out_h, x.device, x.dtype)
    x = x[:, i0] * wy0[None, :, None, None] + x[:, i1] * wy[None, :, None, None]
    j0, j1, wx, wx0 = ac_taps_on(w, out_w, x.device, x.dtype)
    return x[:, :, j0] * wx0[None, None, :, None] + x[:, :, j1] * wx[None, None, :, None]


def flow_scale(h: int, w: int, target_h: int, target_w: int, device, dtype) -> torch.Tensor:
    """``[target_w / w, target_h / h]`` on ``device``."""
    return device_constant(
        ("flow_scale", h, w, target_h, target_w, device, dtype),
        lambda: torch.tensor([target_w / w, target_h / h], dtype=dtype, device=device))


def resize_flow2d(flow: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Resize a ``[B, H, W, 2]`` flow field and rescale its components."""
    h, w = flow.shape[1:3]
    if (h, w) == (target_h, target_w):
        return flow
    flow = resize_bilinear_ac(flow, target_h, target_w)
    return flow * flow_scale(h, w, target_h, target_w, flow.device, flow.dtype)


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
