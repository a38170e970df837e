"""Local 2-D cost volume, plain PyTorch (frozen copy of the plain path of
``rpeflow_tpu_torch/ops/correlation.py``), with autograd.

For every pixel, the mean over channels of ``f1(y, x) . f2(y+dy, x+dx)`` for
all ``|dy|, |dx| <= d``, zero outside the frame; output channel
``(dy+d)(2d+1) + (dx+d)``. :func:`correlation2d_fwd` and
:func:`correlation2d_bwd` are the two functions the port's kernel computes;
each counts as one call of it (:func:`benchmark.lib.flops.counted`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...lib.flops import counted


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


def correlation2d_bwd_plain(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                            max_displacement: int):
    """Gradients of the cost volume for ``f1`` and ``f2`` given ``g``:
    ``d corr[ch(i,j)] / d f1 = shift(f2, i, j) / C``, and each ``g_ij * f1 / C``
    lands on ``f2`` at the pixel it was multiplied with (accumulated in a
    d-padded buffer, then cropped)."""
    d = max_displacement
    _, h, w, c = f1.shape
    side = 2 * d + 1
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    grad1 = torch.zeros_like(f1)
    grad2p = torch.zeros_like(f2p)
    for i in range(side):
        for j in range(side):
            gc = g[..., i * side + j, None] / c
            grad1 += gc * f2p[:, i:i + h, j:j + w]
            grad2p[:, i:i + h, j:j + w] += gc * f1
    return grad1, grad2p[:, d:d + h, d:d + w]


def _check(name: str, f1: torch.Tensor, f2: torch.Tensor) -> None:
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"{name}: shapes {tuple(f1.shape)}, {tuple(f2.shape)}")


@counted("correlation2d",
         lambda f1, f2, max_displacement: (*f1.shape, max_displacement))
def correlation2d_fwd(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int) -> torch.Tensor:
    """Cost volume ``[B, H, W, (2d+1)^2]`` of ``f1, f2 [B, H, W, C]``."""
    _check("correlation2d", f1, f2)
    return correlation2d_plain(f1, f2, max_displacement)


@counted("correlation2d_bwd",
         lambda f1, f2, g, max_displacement: (*f1.shape, max_displacement))
def correlation2d_bwd(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                      max_displacement: int):
    """``(grad1, grad2)`` of the cost volume for the output gradient ``g``."""
    _check("correlation2d_bwd", f1, f2)
    return correlation2d_bwd_plain(f1, f2, g, max_displacement)


class _Correlation2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        f1, f2 = f1.contiguous(), f2.contiguous()
        ctx.save_for_backward(f1, f2)
        ctx.max_displacement = max_displacement
        return correlation2d_fwd(f1, f2, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        grad1, grad2 = correlation2d_bwd(f1, f2, g.contiguous(), ctx.max_displacement)
        return grad1, grad2, None


def correlation2d(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int) -> torch.Tensor:
    """Differentiable cost volume."""
    return _Correlation2D.apply(f1, f2, max_displacement)
