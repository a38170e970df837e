"""Restormer-style MDTA cross-attention block (counterpart of
rpeflow_tpu/nn/mdta.py), channels-last.

:class:`CrossTransformerBlock` always takes the fused form: the attention is
:func:`~rpeflow_tpu_torch.ops.mdta.mdta_attention` (the MDTA kernel and its
glue forward, a recomputed ``_attn_ref_flat`` backward). On 2-D maps the
feed-forward is :func:`~rpeflow_tpu_torch.ops.gdfn.gdfn`; on point maps it
is the plain composition (1x1 conv, k=3 depthwise conv through the
:func:`~rpeflow_tpu_torch.ops.dwconv.dwconv` kernel, exact GELU gate, 1x1
conv). When gradients are on, the whole block is one activation checkpoint
(``torch.utils.checkpoint``, non-reentrant), the remat unit of the JAX
model (``rpeflow_tpu/model/core.py`` wraps it in ``nn.remat``); it holds no
batch norm and no random draw, so its recomputation is exact.

Parameter names and shapes are the upstream ones (``norm1x.body.weight``,
``attn.qkv_dwconv.weight [3C, 1, 3(, 3)]``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.dwconv import dwconv
from ..ops.gdfn import gdfn
from ..ops.mdta import channel_layer_norm, mdta_attention


class _LayerNormBody(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class ChannelLayerNorm(nn.Module):
    """WithBias LayerNorm over the channel axis (parameters under ``body``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = _LayerNormBody(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x.float(), self.body.weight, self.body.bias)


def _conv(n_spatial: int, cin: int, cout: int, k: int, groups: int = 1):
    conv = nn.Conv2d if n_spatial == 2 else nn.Conv1d
    return conv(cin, cout, k, padding=k // 2, groups=groups, bias=False)


class MutualAttention(nn.Module):
    """Parameters of the transposed cross-attention (q from x, k/v from y)."""

    def __init__(self, dim: int, num_heads: int, n_spatial: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv_dwconv = _conv(n_spatial, 3 * dim, 3 * dim, 3, groups=3 * dim)
        self.project_out = _conv(n_spatial, dim, dim, 1)

    def forward(self, x4: torch.Tensor, y4: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
        """``x4, y4 [B, H, W, C]`` (points as ``[B, 1, N, C]``) -> attention
        output before the residual, same shape."""
        c = x4.shape[-1]
        kh = 3 if self.qkv_dwconv.weight.dim() == 4 else 1
        dw = self.qkv_dwconv.weight.reshape(3 * c, kh, 3).permute(1, 2, 0)
        w_out = self.project_out.weight.reshape(c, c).t()
        return mdta_attention(x4, y4, ln, dw, self.temperature, w_out, kh, self.num_heads)


class FeedForward(nn.Module):
    """Gated-DConv feed-forward (GDFN), no biases."""

    def __init__(self, dim: int, ffn_expansion_factor: float, n_spatial: int):
        super().__init__()
        self.hidden = int(dim * ffn_expansion_factor)
        self.n_spatial = n_spatial
        self.project_in = _conv(n_spatial, dim, 2 * self.hidden, 1)
        self.dwconv = _conv(n_spatial, 2 * self.hidden, 2 * self.hidden, 3,
                            groups=2 * self.hidden)
        self.project_out = _conv(n_spatial, self.hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h2 = 2 * self.hidden
        w_in = self.project_in.weight.reshape(h2, -1).t().contiguous()
        w_out = self.project_out.weight.reshape(-1, self.hidden).t().contiguous()
        if self.n_spatial == 2:
            w_dw = self.dwconv.weight.reshape(h2, 3, 3).permute(1, 2, 0).contiguous()
            return gdfn(x.contiguous(), w_in, w_dw, w_out)
        taps = self.dwconv.weight.reshape(h2, 1, 3).permute(1, 2, 0)
        hid = dwconv(torch.matmul(x, w_in)[:, None], taps)[:, 0]
        g = F.gelu(hid[..., :self.hidden], approximate="none") * hid[..., self.hidden:]
        return torch.matmul(g, w_out)


class CrossTransformerBlock(nn.Module):
    """norm -> cross-attention -> residual -> norm -> GDFN -> residual.

    ``n_spatial`` is 2 for ``[B, H, W, C]`` maps and 1 for ``[B, N, C]``
    point maps (1-D k=3 convs).
    """

    def __init__(self, dim: int, num_heads: int, n_spatial: int,
                 ffn_expansion_factor: float = 2.66):
        super().__init__()
        self.n_spatial = n_spatial
        self.norm1x = ChannelLayerNorm(dim)
        self.norm1y = ChannelLayerNorm(dim)
        self.attn = MutualAttention(dim, num_heads, n_spatial)
        self.norm2 = ChannelLayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor, n_spatial)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape != y.shape:
            raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)}")
        if torch.is_grad_enabled():
            return checkpoint(self._forward, x, y, use_reentrant=False)
        return self._forward(x, y)

    def _forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = y.float()
        x4 = x if self.n_spatial == 2 else x[:, None]
        y4 = y if self.n_spatial == 2 else y[:, None]
        ln = torch.stack([self.norm1x.body.weight, self.norm1x.body.bias,
                          self.norm1y.body.weight, self.norm1y.body.bias])
        a = self.attn(x4.contiguous(), y4.contiguous(), ln)
        x = x + (a if self.n_spatial == 2 else a[:, 0])
        return x + self.ffn(self.norm2(x))
