"""Gated depthwise-conv feed-forward, plain PyTorch (frozen copy of the plain
path of ``rpeflow_tpu_torch/ops/gdfn.py``), with autograd.

``y = (gelu(h1) * h2) @ w_out`` with ``[h1 | h2] = dw3x3(x @ w_in)``, zero
padding, no biases, exact GELU. :func:`gdfn_fwd` counts as one call of the
port's kernel; :func:`gdfn`'s backward recomputes the composition with the
differentiable depthwise conv and differentiates it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...lib.flops import counted
from ._autograd import vjp_by_recompute
from .dwconv import dwconv, dwconv_plain


def gdfn_plain(x, w_in, w_dw, w_out, dw_fn=dwconv_plain):
    """``_gdfn_ref``, with ``dw_fn`` as its depthwise conv."""
    hidden = w_in.shape[1] // 2
    h = dw_fn(torch.matmul(x, w_in), w_dw)
    g = F.gelu(h[..., :hidden], approximate="none") * h[..., hidden:]
    return torch.matmul(g, w_out)


@counted("gdfn", lambda x, w_in, w_dw, w_out: (*x.shape, w_out.shape[0]))
def gdfn_fwd(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """``x [B, H, W, C]``, ``w_in [C, 2h]``, ``w_dw [3, 3, 2h]``,
    ``w_out [h, C]`` -> ``[B, H, W, C]`` float32 ."""
    b, h, w, c = x.shape
    h2 = w_in.shape[1]
    hidden = h2 // 2
    if w_in.shape != (c, h2) or w_dw.shape != (3, 3, h2) or w_out.shape != (hidden, c):
        raise ValueError(f"gdfn: shapes {tuple(x.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(w_dw.shape)}, {tuple(w_out.shape)}")
    return gdfn_plain(x, w_in, w_dw, w_out)


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
    """Differentiable GDFN (its backward recomputes the plain composition)."""
    return _GDFN.apply(x, w_in, w_dw, w_out)
