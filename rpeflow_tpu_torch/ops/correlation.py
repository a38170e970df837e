"""Local 2-D cost volume (counterpart of rpeflow_tpu/ops/correlation.py and
the Pallas kernel rpeflow_tpu/ops/pallas/correlation.py), forward only.

For every pixel, the mean over channels of ``f1(y, x) . f2(y+dy, x+dx)`` for
all ``|dy|, |dx| <= d``, zero outside the frame; output channel
``(dy+d)(2d+1) + (dx+d)``. :func:`correlation2d` launches ``csrc/correlation.cu``
for CUDA tensors and runs :func:`correlation2d_plain` for CPU tensors. The
JAX package uses its kernel only on maps of at least 2048 pixels; the port
uses it at every decode level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def correlation2d_plain(f1: torch.Tensor, f2: torch.Tensor,
                        max_displacement: int) -> torch.Tensor:
    """Shifted-multiply form of ``correlation2d_ref``: ``[B,H,W,C]`` x2 ->
    ``[B,H,W,(2d+1)^2]``."""
    d = max_displacement
    _, h, w, _ = f1.shape
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    outs = [(f1 * f2p[:, i:i + h, j:j + w]).mean(-1)
            for i in range(2 * d + 1) for j in range(2 * d + 1)]
    return torch.stack(outs, dim=-1)


def correlation2d(f1: torch.Tensor, f2: torch.Tensor,
                  max_displacement: int) -> torch.Tensor:
    """Cost volume ``[B, H, W, (2d+1)^2]`` of float32 ``f1, f2 [B, H, W, C]``."""
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"correlation2d: shapes {tuple(f1.shape)}, {tuple(f2.shape)}")
    if f1.device.type == "cpu":
        return correlation2d_plain(f1, f2, max_displacement)
    if not 0 <= max_displacement <= 4:
        raise ValueError("correlation2d: the kernel takes max_displacement <= 4")
    _cuda.require_cuda("correlation2d", f1, f2)
    b, h, w, c = f1.shape
    side = 2 * max_displacement + 1
    out = torch.empty(b, h, w, side * side, dtype=torch.float32, device=f1.device)
    _cuda.check(_cuda.lib().rpeflow_correlation2d(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, max_displacement,
        _cuda.stream()), "correlation2d")
    _cuda.LAUNCHES["correlation2d"] += 1
    return out
