"""Bilinear sampling in pixel coordinates with align_corners semantics
(frozen copy of rpeflow_tpu_torch/ops/sample.py).

Sampling is written out with gathers in pixel space, as in the JAX package,
so both padding modes match it term for term: ``zeros`` takes each tap's
validity from the unclamped coordinates, ``border`` clamps the coordinates
first. A NaN position samples NaN, as there.
"""

from __future__ import annotations

import torch


def mesh_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Pixel grid ``[H, W, 2]`` with last dim (x, y)."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=dtype),
                            torch.arange(w, device=device, dtype=dtype), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def grid_sample_2d(feat: torch.Tensor, xy: torch.Tensor,
                   padding_mode: str) -> torch.Tensor:
    """Sample ``feat [B, H, W, C]`` at pixel positions ``xy [B, ..., 2]``
    (x, y) -> ``[B, ..., C]``. ``padding_mode`` is ``"zeros"`` or ``"border"``.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(padding_mode)
    b, h, w, c = feat.shape
    lead = xy.shape[1:-1]
    xy = xy.reshape(b, -1, 2).float()
    x, y = xy[..., 0], xy[..., 1]
    if padding_mode == "border":
        x = x.clamp(0, w - 1)
        y = y.clamp(0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(feat.dtype)
    wy = (y - y0)[..., None].to(feat.dtype)
    # a NaN position (a non-finite flow) gathers pixel 0 with NaN weights, so
    # its output is NaN, as in the JAX package, not an index out of range
    inf = float("inf")
    x0 = x0.nan_to_num(0.0, inf, -inf)
    y0 = y0.nan_to_num(0.0, inf, -inf)
    flat_feat = feat.reshape(b, h * w, c)
    rows = torch.arange(b, device=feat.device)[:, None]

    def tap(xi, yi):
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        v = flat_feat[rows, yc * w + xc]
        if padding_mode == "border":
            return v
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        return v * valid[..., None].to(v.dtype)

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return out.reshape((b,) + tuple(lead) + (c,))


def backwarp_2d(feat: torch.Tensor, flow: torch.Tensor,
                padding_mode: str) -> torch.Tensor:
    """``out(y, x) = feat(y + flow_y, x + flow_x)``, bilinear, align_corners."""
    _, h, w, _ = feat.shape
    grid = mesh_grid(h, w, device=feat.device)[None]
    return grid_sample_2d(feat, grid + flow.float(), padding_mode)
