"""Gated depthwise-conv feed-forward (counterpart of the Pallas kernel
rpeflow_tpu/ops/pallas/gdfn.py), with autograd.

``y = (gelu(h1) * h2) @ w_out`` with ``[h1 | h2] = dw3x3(x @ w_in)``, zero
padding, no biases, exact GELU (``rpeflow_tpu/nn/mdta.py : _gdfn_ref``).
:func:`gdfn_fwd` launches ``csrc/gdfn.cu`` for CUDA tensors and runs
:func:`gdfn_plain` for CPU tensors. :func:`gdfn` is differentiable: its
forward is :func:`gdfn_fwd`, and its backward recomputes the plain
composition with the differentiable K5 depthwise conv
(:func:`~rpeflow_tpu_torch.ops.dwconv.dwconv`), as the JAX ``_gdfn_bwd``
differentiates ``_gdfn_ref``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from ._autograd import vjp_by_recompute
from .dwconv import dwconv, dwconv_plain


def gdfn_plain(x, w_in, w_dw, w_out, dw_fn=dwconv_plain):
    """``_gdfn_ref``, with ``dw_fn`` as its depthwise conv."""
    hidden = w_in.shape[1] // 2
    h = dw_fn(torch.matmul(x, w_in), w_dw)
    g = F.gelu(h[..., :hidden], approximate="none") * h[..., hidden:]
    return torch.matmul(g, w_out)


def gdfn_fwd(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """``x [B, H, W, C]``, ``w_in [C, 2h]``, ``w_dw [3, 3, 2h]``,
    ``w_out [h, C]`` -> ``[B, H, W, C]`` float32 (the K4 kernel for CUDA
    tensors, records no gradient)."""
    b, h, w, c = x.shape
    h2 = w_in.shape[1]
    hidden = h2 // 2
    if w_in.shape != (c, h2) or w_dw.shape != (3, 3, h2) or w_out.shape != (hidden, c):
        raise ValueError(f"gdfn: shapes {tuple(x.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(w_dw.shape)}, {tuple(w_out.shape)}")
    if x.device.type == "cpu":
        return gdfn_plain(x, w_in, w_dw, w_out)
    if -(-b * h * w // 64) > 65535:
        raise ValueError("gdfn: too many pixels for the kernel's grid")
    _cuda.require_cuda("gdfn", x, w_in, w_dw, w_out)
    pixels = b * h * w
    scratch = torch.empty(pixels * 3 * hidden, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().rpeflow_gdfn(
        x.data_ptr(), w_in.data_ptr(), w_dw.data_ptr(), w_out.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, h, w, c, hidden, _cuda.stream()), "gdfn")
    _cuda.LAUNCHES["gdfn"] += 1
    return out


class _GDFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_in, w_dw, w_out):
        args = [t.contiguous() for t in (x, w_in, w_dw, w_out)]
        ctx.save_for_backward(*args)
        return gdfn_fwd(*args)

    @staticmethod
    def backward(ctx, g):
        return vjp_by_recompute(lambda *a: gdfn_plain(*a, dw_fn=dwconv), ctx.saved_tensors,
                                ctx.needs_input_grad, g)


def gdfn(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
         w_out: torch.Tensor) -> torch.Tensor:
    """Differentiable GDFN (K4 forward, K5 inside the recomputed backward)."""
    return _GDFN.apply(x, w_in, w_dw, w_out)
