"""Fused-form MDTA attention, plain PyTorch (frozen copy of the plain path of
``rpeflow_tpu_torch/ops/mdta.py``), with autograd.

:func:`mdta_qkv` computes, for ``x, y [B, H, W, C]`` (point maps as
``[B, 1, N, C]``), the channel LayerNorm of x and y, the depthwise ``kh x 3``
conv giving q from x and k, v from y, and returns ``v``,
``qk = sum_t q_t^T k_t [B, C, C]`` and ``sq = (sum_t q^2, sum_t k^2)
[B, 2, C]``; it counts as one call of the port's kernel.
:func:`mdta_attention` is the whole attention before the residual: forward
through :func:`mdta_qkv` and the glue of :func:`mdta_attention_fused`,
backward by recomputing :func:`mdta_attention_plain` with the differentiable
depthwise conv.
"""

from __future__ import annotations

import torch

from ...lib.flops import counted
from ._autograd import vjp_by_recompute
from .dwconv import dwconv, dwconv_plain


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps inside the sqrt."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * weight + bias


def mdta_qkv_plain(x, y, ln, dw, kh):
    c = x.shape[-1]
    xn = channel_layer_norm(x, ln[0], ln[1])
    yn = channel_layer_norm(y, ln[2], ln[3])
    q = dwconv_plain(xn, dw[..., :c])
    k = dwconv_plain(yn, dw[..., c:2 * c])
    v = dwconv_plain(yn, dw[..., 2 * c:])
    b = x.shape[0]
    qf, kf = q.reshape(b, -1, c), k.reshape(b, -1, c)
    qk = torch.matmul(qf.transpose(1, 2), kf)
    sq = torch.stack([(qf * qf).sum(1), (kf * kf).sum(1)], dim=1)
    return v.contiguous(), qk, sq


@counted("mdta_qkv", lambda x, y, ln, dw, kh: (*x.shape, kh))
def mdta_qkv(x: torch.Tensor, y: torch.Tensor, ln: torch.Tensor, dw: torch.Tensor,
             kh: int):
    """``x, y [B, H, W, C]``, ``ln [4, C]`` rows (lnx_w, lnx_b, lny_w, lny_b),
    ``dw [kh, 3, 3C]`` taps in (q | k | v) order; kh is 3 for 2-D maps and 1
    for point maps. Returns ``(v, qk, sq)``."""
    b, h, w, c = x.shape
    if y.shape != x.shape or ln.shape != (4, c) or dw.shape != (kh, 3, 3 * c):
        raise ValueError(f"mdta_qkv: shapes {tuple(x.shape)}, {tuple(ln.shape)}, "
                         f"{tuple(dw.shape)}, kh={kh}")
    return mdta_qkv_plain(x, y, ln, dw, kh)


def mdta_attention_fused(x, y, ln, dw, temperature, w_out, kh: int, heads: int):
    """The attention through :func:`mdta_qkv` and the glue above.
    ``temperature [heads, 1, 1]``, ``w_out [C, C]`` (``out = a @ w_out``)."""
    b, h, w, c = x.shape
    hc = c // heads
    v, qk, sq = mdta_qkv(x, y, ln, dw, kh)
    eps = 1e-12
    nq = torch.sqrt(torch.clamp(sq[:, 0], min=eps * eps))
    nk = torch.sqrt(torch.clamp(sq[:, 1], min=eps * eps))
    logits = qk / (nq[:, :, None] * nk[:, None, :])
    lr = logits.reshape(b, heads, hc, heads, hc)
    blocks = torch.stack([lr[:, i, :, i, :] for i in range(heads)], dim=1)
    attn = torch.softmax(blocks * temperature, dim=-1)  # [B, heads, hc, hc]
    eye = torch.eye(heads, dtype=attn.dtype, device=attn.device)
    bd = torch.einsum("bhcd,hg->bhdgc", attn, eye).reshape(b, c, c)
    m = torch.matmul(bd, w_out)
    return torch.matmul(v.reshape(b, h * w, c), m).reshape(b, h, w, c)


def mdta_attention_plain(x, y, ln, dw, temperature, w_out, kh: int, heads: int,
                         dw_fn=dwconv_plain):
    """``_attn_ref_flat``: LayerNorms, depthwise q/k/v through ``dw_fn``,
    l2-normalised transposed attention per head, projection."""
    b, h, w, c = x.shape
    xn = channel_layer_norm(x, ln[0], ln[1])
    yn = channel_layer_norm(y, ln[2], ln[3])
    q = dw_fn(xn, dw[..., :c])
    k = dw_fn(yn, dw[..., c:2 * c])
    v = dw_fn(yn, dw[..., 2 * c:])
    t, hc = h * w, c // heads
    q, k, v = (z.reshape(b, t, heads, hc) for z in (q, k, v))
    eps = 1e-12
    q = q / torch.sqrt(torch.clamp((q * q).sum(1, keepdim=True), min=eps * eps))
    k = k / torch.sqrt(torch.clamp((k * k).sum(1, keepdim=True), min=eps * eps))
    attn = torch.softmax(torch.einsum("bthc,bthd->bhcd", q, k) * temperature, dim=-1)
    out = torch.einsum("bhcd,bthd->bthc", attn, v)
    return torch.matmul(out.reshape(b, t, c), w_out).reshape(b, h, w, c)


class _MDTAAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, ln, dw, temperature, w_out, kh, heads):
        args = [t.contiguous() for t in (x, y, ln, dw, temperature, w_out)]
        ctx.save_for_backward(*args)
        ctx.kh, ctx.heads = kh, heads
        return mdta_attention_fused(*args, kh, heads)

    @staticmethod
    def backward(ctx, g):
        kh, heads = ctx.kh, ctx.heads
        grads = vjp_by_recompute(
            lambda *a: mdta_attention_plain(*a, kh, heads, dw_fn=dwconv),
            ctx.saved_tensors, ctx.needs_input_grad[:6], g)
        return (*grads, None, None)


def mdta_attention(x, y, ln, dw, temperature, w_out, kh: int, heads: int) -> torch.Tensor:
    """Differentiable MDTA attention before the residual (its backward
    recomputes :func:`mdta_attention_plain`). ``x, y [B, H, W, C]`` (points
    ``[B, 1, N, C]``), ``ln [4, C]``, ``dw [kh, 3, 3C]``,
    ``temperature [heads, 1, 1]``, ``w_out [C, C]``."""
    return _MDTAAttention.apply(x, y, ln, dw, temperature, w_out, kh, heads)
