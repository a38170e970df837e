"""Depthwise ``kh x 3`` convolution with autograd, plain PyTorch (frozen copy
of the plain path of ``rpeflow_tpu_torch/ops/dwconv.py``).

``x [B, H, W, C]``, ``taps [kh, 3, C]`` -> ``[B, H, W, C]``: zero padding,
no bias, channels-last; ``kh`` is 3 for 2-D maps and 1 for point maps
``[B, 1, N, C]``. :func:`dwconv_fwd` and :func:`dwconv_bwd` each count as
one call of the port's kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...lib.flops import counted


def dwconv_plain(z: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise ``kh x 3`` conv through ``F.conv2d`` (groups = C)."""
    kh, _, c = taps.shape
    weight = taps.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, 3]
    out = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=(kh // 2, 1), groups=c)
    return out.permute(0, 2, 3, 1)


def dwconv_bwd_plain(x: torch.Tensor, g: torch.Tensor, taps: torch.Tensor,
                     need_dx: bool = True, need_dtaps: bool = True):
    """``(dx, dtaps)`` of :func:`dwconv_plain` at ``x`` for the output
    gradient ``g`` (None where not needed): ``dx`` the conv of ``g`` with the
    taps rotated by 180 degrees, ``dtaps[i, j] = sum_{b,y,x} g[b,y,x] *
    x[b, y+i-kh//2, x+j-1]``."""
    kh = taps.shape[0]
    dx = dwconv_plain(g, taps.flip(0, 1)) if need_dx else None
    dtaps = None
    if need_dtaps:
        _, h, w, _ = x.shape
        ph = kh // 2
        xp = F.pad(x, (0, 0, 1, 1, ph, ph))
        dtaps = torch.stack([(g * xp[:, i:i + h, j:j + w]).sum((0, 1, 2))
                             for i in range(kh) for j in range(3)]).reshape(kh, 3, -1)
    return dx, dtaps


def _check(name: str, x: torch.Tensor, kh: int, c: int) -> None:
    if x.dim() != 4 or x.shape[-1] != c or kh not in (1, 3):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, kh={kh}, C={c}")



@counted("dwconv", lambda x, taps: (*x.shape, taps.shape[0]))
def dwconv_fwd(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The depthwise conv's forward."""
    kh, _, c = taps.shape
    _check("dwconv", x, kh, c)
    return dwconv_plain(x, taps)


@counted("dwconv_bwd", lambda x, g, taps, need_dx=True, need_dtaps=True:
         (*x.shape, taps.shape[0], int(need_dx) + int(need_dtaps)))
def dwconv_bwd(x: torch.Tensor, g: torch.Tensor, taps: torch.Tensor,
               need_dx: bool = True, need_dtaps: bool = True):
    """``(dx, dtaps)`` for the output gradient ``g`` (None where not needed)."""
    kh, _, c = taps.shape
    _check("dwconv_bwd", x, kh, c)
    if g.shape != x.shape:
        raise ValueError(f"dwconv_bwd: shapes {tuple(x.shape)}, {tuple(g.shape)}")
    return dwconv_bwd_plain(x, g, taps, need_dx, need_dtaps)


class _DWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        x, taps = x.contiguous(), taps.contiguous()
        ctx.save_for_backward(x, taps)
        return dwconv_fwd(x, taps)

    @staticmethod
    def backward(ctx, g):
        x, taps = ctx.saved_tensors
        return dwconv_bwd(x, g.contiguous(), taps, *ctx.needs_input_grad)


def dwconv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Differentiable depthwise ``kh x 3`` conv."""
    return _DWConv.apply(x, taps)
