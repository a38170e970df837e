"""Fused MDTA front half (counterpart of the Pallas kernel
rpeflow_tpu/ops/pallas/mdta.py), forward only.

:func:`mdta_qkv` computes, for ``x, y [B, H, W, C]`` (point maps as
``[B, 1, N, C]``), the channel LayerNorm of x and y, the depthwise ``kh x 3``
conv giving q from x and k, v from y (zero padding applied to the LayerNorm
output), and returns ``v``, ``qk = sum_t q_t^T k_t [B, C, C]`` and
``sq = (sum_t q^2, sum_t k^2) [B, 2, C]``. It launches ``csrc/mdta.cu`` for
CUDA tensors and runs :func:`mdta_qkv_plain` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps inside the sqrt."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * weight + bias


def depthwise_conv(z: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise ``kh x 3`` conv, zero padding, no bias.
    ``z [B, H, W, C]``, ``taps [kh, 3, C]`` -> ``[B, H, W, C]``."""
    kh, _, c = taps.shape
    weight = taps.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, 3]
    out = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=(kh // 2, 1), groups=c)
    return out.permute(0, 2, 3, 1)


def mdta_qkv_plain(x, y, ln, dw, kh):
    c = x.shape[-1]
    xn = channel_layer_norm(x, ln[0], ln[1])
    yn = channel_layer_norm(y, ln[2], ln[3])
    q = depthwise_conv(xn, dw[..., :c])
    k = depthwise_conv(yn, dw[..., c:2 * c])
    v = depthwise_conv(yn, dw[..., 2 * c:])
    b = x.shape[0]
    qf, kf = q.reshape(b, -1, c), k.reshape(b, -1, c)
    qk = torch.matmul(qf.transpose(1, 2), kf)
    sq = torch.stack([(qf * qf).sum(1), (kf * kf).sum(1)], dim=1)
    return v.contiguous(), qk, sq


def mdta_qkv(x: torch.Tensor, y: torch.Tensor, ln: torch.Tensor, dw: torch.Tensor,
             kh: int):
    """``x, y [B, H, W, C]``, ``ln [4, C]`` rows (lnx_w, lnx_b, lny_w, lny_b),
    ``dw [kh, 3, 3C]`` taps in (q | k | v) order; kh is 3 for 2-D maps and 1
    for point maps. Returns ``(v, qk, sq)``, float32."""
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
