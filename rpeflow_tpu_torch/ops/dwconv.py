"""Depthwise ``kh x 3`` convolution with autograd (counterpart of the Pallas
kernel rpeflow_tpu/ops/pallas/dwconv.py and of its oracle
``rpeflow_tpu/nn/mdta.py : _dw_flat``).

``x [B, H, W, C]``, ``taps [kh, 3, C]`` -> ``[B, H, W, C]``: zero padding,
no bias, channels-last; ``kh`` is 3 for 2-D maps and 1 for point maps
``[B, 1, N, C]``. :func:`dwconv` is differentiable:

* forward: the ``csrc/dwconv.cu`` kernel (K5);
* input gradient: K5 again, on the output gradient with the taps rotated by
  180 degrees (``taps.flip(0, 1)``), exact for a stride-1 zero-padded
  cross-correlation;
* taps gradient: the kernel's second entry point,
  ``sum_{b,y,x} g * shift(x)`` per tap, summed in a fixed order.

The raw wrappers :func:`dwconv_fwd` and :func:`dwconv_taps_grad` launch the
kernel for CUDA tensors and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def dwconv_plain(z: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise ``kh x 3`` conv through ``F.conv2d`` (groups = C)."""
    kh, _, c = taps.shape
    weight = taps.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, 3]
    out = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=(kh // 2, 1), groups=c)
    return out.permute(0, 2, 3, 1)


def dwconv_taps_grad_plain(x: torch.Tensor, g: torch.Tensor, kh: int) -> torch.Tensor:
    """``dtaps[i, j] = sum_{b,y,x} g[b,y,x] * x[b, y+i-kh//2, x+j-1]`` -> ``[kh, 3, C]``."""
    _, h, w, _ = x.shape
    ph = kh // 2
    xp = F.pad(x, (0, 0, 1, 1, ph, ph))
    taps = [(g * xp[:, i:i + h, j:j + w]).sum((0, 1, 2)) for i in range(kh) for j in range(3)]
    return torch.stack(taps).reshape(kh, 3, -1)


def _check(name: str, x: torch.Tensor, kh: int, c: int) -> None:
    if x.dim() != 4 or x.shape[-1] != c or kh not in (1, 3):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, kh={kh}, C={c}")


def dwconv_fwd(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The K5 forward for CUDA tensors, :func:`dwconv_plain` for CPU tensors."""
    kh, _, c = taps.shape
    _check("dwconv", x, kh, c)
    if x.device.type == "cpu":
        return dwconv_plain(x, taps)
    _cuda.require_cuda("dwconv", x, taps)
    b, h, w, _ = x.shape
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().rpeflow_dwconv(
        x.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, w, c, kh, _cuda.stream()), "dwconv")
    _cuda.LAUNCHES["dwconv"] += 1
    return out


def dwconv_taps_grad(x: torch.Tensor, g: torch.Tensor, kh: int) -> torch.Tensor:
    """The K5 taps gradient for CUDA tensors, :func:`dwconv_taps_grad_plain`
    for CPU tensors. ``x, g [B, H, W, C]`` -> ``[kh, 3, C]``."""
    c = x.shape[-1]
    _check("dwconv_taps_grad", x, kh, c)
    if g.shape != x.shape:
        raise ValueError(f"dwconv_taps_grad: shapes {tuple(x.shape)}, {tuple(g.shape)}")
    if x.device.type == "cpu":
        return dwconv_taps_grad_plain(x, g, kh)
    _cuda.require_cuda("dwconv_taps_grad", x, g)
    b, h, w, _ = x.shape
    lib = _cuda.lib()
    blocks = lib.rpeflow_dwconv_taps_blocks(b, h, w, c)
    scratch = torch.empty(blocks * kh * 3 * c, dtype=torch.float32, device=x.device)
    dtaps = torch.empty(kh, 3, c, dtype=torch.float32, device=x.device)
    _cuda.check(lib.rpeflow_dwconv_taps_grad(
        x.data_ptr(), g.data_ptr(), dtaps.data_ptr(), scratch.data_ptr(), b, h, w, c, kh,
        _cuda.stream()), "dwconv_taps_grad")
    _cuda.LAUNCHES["dwconv"] += 1
    return dtaps


class _DWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        x, taps = x.contiguous(), taps.contiguous()
        ctx.save_for_backward(x, taps)
        return dwconv_fwd(x, taps)

    @staticmethod
    def backward(ctx, g):
        x, taps = ctx.saved_tensors
        g = g.contiguous()
        dx = dwconv_fwd(g, taps.flip(0, 1).contiguous()) if ctx.needs_input_grad[0] else None
        dtaps = dwconv_taps_grad(x, g, taps.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dtaps


def dwconv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Differentiable depthwise ``kh x 3`` conv (K5 forward and backward)."""
    return _DWConv.apply(x, taps)

