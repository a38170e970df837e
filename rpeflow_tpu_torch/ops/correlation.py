"""Local 2-D cost volume (counterpart of rpeflow_tpu/ops/correlation.py and
the Pallas kernel rpeflow_tpu/ops/pallas/correlation.py), with autograd.

For every pixel, the mean over channels of ``f1(y, x) . f2(y+dy, x+dx)`` for
all ``|dy|, |dx| <= d``, zero outside the frame; output channel
``(dy+d)(2d+1) + (dx+d)``. :func:`correlation2d_fwd` launches
``csrc/correlation.cu`` for CUDA tensors and runs :func:`correlation2d_plain`
for CPU tensors. The JAX package uses its kernel only on maps of at least
2048 pixels; the port uses it at every decode level.

:func:`correlation2d` is differentiable: its forward is
:func:`correlation2d_fwd` and its backward the shift algebra of
``rpeflow_tpu/ops/correlation.py : _correlation2d_bwd_ref`` in plain
PyTorch (:func:`correlation2d_bwd_plain`), as the JAX package computes it
in XLA, not in a kernel.
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


def correlation2d_fwd(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int) -> torch.Tensor:
    """Cost volume ``[B, H, W, (2d+1)^2]`` of float32 ``f1, f2 [B, H, W, C]``
    (the K2 kernel for CUDA tensors, records no gradient)."""
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


class _Correlation2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        ctx.save_for_backward(f1, f2)
        ctx.max_displacement = max_displacement
        return correlation2d_fwd(f1, f2, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        grad1, grad2 = correlation2d_bwd_plain(f1, f2, g, ctx.max_displacement)
        return grad1, grad2, None


def correlation2d(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int) -> torch.Tensor:
    """Differentiable cost volume (K2 forward, plain shift-algebra backward)."""
    return _Correlation2D.apply(f1, f2, max_displacement)
