"""Fused MDTA attention (counterpart of the Pallas kernel
rpeflow_tpu/ops/pallas/mdta.py and of ``rpeflow_tpu/nn/mdta.py :
_mdta_attn_fused``), with autograd.

:func:`mdta_qkv` computes, for ``x, y [B, H, W, C]`` (point maps as
``[B, 1, N, C]``), the channel LayerNorm of x and y, the depthwise ``kh x 3``
conv giving q from x and k, v from y (zero padding applied to the LayerNorm
output), and returns ``v``, ``qk = sum_t q_t^T k_t [B, C, C]`` and
``sq = (sum_t q^2, sum_t k^2) [B, 2, C]``. It launches ``csrc/mdta.cu`` for
CUDA tensors and runs :func:`mdta_qkv_plain` for CPU tensors.

:func:`mdta_attention` is the whole attention before the residual, one
autograd function over ``(x, y, ln, dw, temperature, w_out)``:

* forward (:func:`mdta_attention_fused`): the kernel, then the glue of the
  JAX ``_mdta_attn_fused``: the token-axis l2 norms fold into the Gram
  matrix, the per-head softmax runs on its diagonal blocks, and
  ``(attn @ v) @ w_out`` becomes ``v @ M`` with
  ``M = blockdiag_h(attn_h^T) @ w_out``;
* backward: recompute :func:`mdta_attention_plain` (``_attn_ref_flat``)
  with the differentiable K5 depthwise conv for every ``kh`` (3 on maps,
  1 on points) and differentiate it.
"""

from __future__ import annotations

import torch

from . import _cuda
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


def mdta_qkv(x: torch.Tensor, y: torch.Tensor, ln: torch.Tensor, dw: torch.Tensor,
             kh: int):
    """``x, y [B, H, W, C]``, ``ln [4, C]`` rows (lnx_w, lnx_b, lny_w, lny_b),
    ``dw [kh, 3, 3C]`` taps in (q | k | v) order; kh is 3 for 2-D maps and 1
    for point maps. Returns ``(v, qk, sq)``, float32 (the K3 kernel for CUDA
    tensors, records no gradient)."""
    b, h, w, c = x.shape
    if y.shape != x.shape or ln.shape != (4, c) or dw.shape != (kh, 3, 3 * c):
        raise ValueError(f"mdta_qkv: shapes {tuple(x.shape)}, {tuple(ln.shape)}, "
                         f"{tuple(dw.shape)}, kh={kh}")
    if x.device.type == "cpu":
        return mdta_qkv_plain(x, y, ln, dw, kh)
    if kh not in (1, 3) or c > 256:
        raise ValueError("mdta_qkv: the kernel takes kh in (1, 3) and C <= 256")
    _cuda.require_cuda("mdta_qkv", x, y, ln, dw)
    lib = _cuda.lib()
    n_chunks = lib.rpeflow_mdta_gram_chunks(h * w)
    elems = b * h * w * c
    scratch = torch.empty(4 * elems + b * n_chunks * (c * c + 2 * c),
                          dtype=torch.float32, device=x.device)
    v = torch.empty_like(x)
    qk = torch.empty(b, c, c, dtype=torch.float32, device=x.device)
    sq = torch.empty(b, 2, c, dtype=torch.float32, device=x.device)
    _cuda.check(lib.rpeflow_mdta_qkv(
        x.data_ptr(), y.data_ptr(), ln.data_ptr(), dw.data_ptr(), v.data_ptr(),
        qk.data_ptr(), sq.data_ptr(), scratch.data_ptr(), b, h, w, c, kh,
        _cuda.stream()), "mdta_qkv")
    _cuda.LAUNCHES["mdta_qkv"] += 1
    return v, qk, sq


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
    """Differentiable MDTA attention before the residual (K3 forward, K5
    inside the recomputed backward). ``x, y [B, H, W, C]`` (points
    ``[B, 1, N, C]``), ``ln [4, C]``, ``dw [kh, 3, 3C]``,
    ``temperature [heads, 1, 1]``, ``w_out [C, C]``."""
    return _MDTAAttention.apply(x, y, ln, dw, temperature, w_out, kh, heads)
