"""Conv / MLP building blocks (counterpart of rpeflow_tpu/nn/layers.py).

Activations stay channels-last (``[B, N, C]`` points, ``[B, H, W, C]``
images) as in the JAX package; parameters carry the upstream torch names
and layouts (``conv_fn.weight [O, I, k(, k)]``, BatchNorm ``norm_fn``), so
JAX-exported and upstream checkpoints load with ``strict=True``. 1x1 convs
(strided ones on the strided slice) run as a matmul over the channel axis;
larger kernels run ``F.conv2d`` on a channels-last view, except where a
subclass overrides :meth:`ConvNormAct.conv` (the 2-D decoder's
``nn/pyramid2d.py : DecoderConv``). Batch norm follows flax (:func:`batch_norm`): batch
statistics with the biased variance in training mode, running statistics
otherwise. The JAX package's space-to-depth first conv (``_S2DConv``) is a
TPU layout trick over the same parameters and is a plain stride-2 conv here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return x
    if activation == "relu":
        return F.relu(x)
    if activation == "leaky_relu":
        return F.leaky_relu(x, negative_slope=0.1)
    raise NotImplementedError(f"Unknown activation function: {activation}")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over the spatial axes, statistics in f32."""
    xf = x.float()
    axes = tuple(range(1, x.dim() - 1))
    mu = xf.mean(axes, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(axes, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)


def batch_norm_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Running-statistics batch norm over the last axis, in flax's order:
    ``(x - mean) * (scale * rsqrt(var + eps)) + bias``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x.float() - bn.running_mean) * mul + bn.bias


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm over every axis but the last, as flax's ``nn.BatchNorm(
    momentum=0.9)`` computes it: in training mode (``bn.training``) it
    normalises with the batch mean and the BIASED batch variance, in flax's
    one-pass form ``max(E[x^2] - E[x]^2, 0)``, and moves the running
    statistics 10% towards them (``torch.nn.BatchNorm`` would store the
    unbiased variance); otherwise it uses the running statistics.
    Statistics are float32, and the output has the input's dtype.

    The batch is the global one: the sums ``[sum x, sum x^2, n]`` are summed
    over the data-parallel ranks (one differentiable all-reduce), so every
    rank normalises with, and moves its running buffers by, the same
    statistics as one process on the whole batch."""
    if not bn.training:
        return batch_norm_eval(bn, x).to(x.dtype)
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    c = x.shape[-1]
    sums = all_reduce_sum(torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                                     xf.new_full((1,), xf.numel() // c)]), "batch_norm")
    mean = sums[:c] / sums[-1]
    var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
        bn.num_batches_tracked += 1
    return ((xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias).to(x.dtype)


def pointwise(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv over the last axis with a ``[O, I, 1(, 1)]`` conv weight."""
    return F.linear(x, weight.reshape(weight.shape[0], -1), bias)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied to a ``[B, H, W, C]`` tensor, result channels-last."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                   conv.padding, conv.dilation, conv.groups)
    return out.permute(0, 2, 3, 1)


class ConvNormAct(nn.Module):
    """Conv -> (batch | instance | no) norm -> (leaky_)relu, channels-last.

    ``n_spatial`` is 2 for ``[B, H, W, C]`` (and ``[B, N, k, C]``) inputs and
    1 for ``[B, N, C]`` point inputs; it fixes the conv weight's rank, as the
    upstream Conv2d / Conv1d did. With a ``dtype`` (the ``amp`` pyramids'
    bfloat16) the conv takes its input and weight in that dtype and adds the
    bias after it, in that dtype, as flax's ``nn.Conv(dtype=...)`` does; the
    norm computes in float32 and casts back, the activation stays in it.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 norm: Optional[str] = None, activation: Optional[str] = "leaky_relu",
                 n_spatial: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if n_spatial == 1 and kernel_size != 1:
            raise NotImplementedError("point convs are pointwise")
        conv = nn.Conv2d if n_spatial == 2 else nn.Conv1d
        self.conv_fn = conv(in_channels, out_channels, kernel_size, stride=stride,
                            padding=padding, dilation=dilation)
        if norm == "batch_norm":
            self.norm_fn = (nn.BatchNorm2d if n_spatial == 2 else nn.BatchNorm1d)(out_channels)
        elif norm not in (None, "instance_norm"):
            raise NotImplementedError(f"Unknown normalization function: {norm}")
        self.norm = norm
        self.activation = activation
        # a 1x1 conv with stride s reads the pixels (s*y, s*x): slice, then
        # matmul (PyTorch's CPU backward of a strided 1x1 conv on a 4-channel
        # channels-last input corrupts the heap)
        self.pointwise = kernel_size == 1 and padding == 0
        self.stride = stride
        self.dtype = dtype

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The block's conv, bias added, channels-last."""
        conv, dtype = self.conv_fn, self.dtype
        weight, bias = conv.weight, conv.bias
        if dtype is not None:
            x, weight, bias = x.to(dtype), weight.to(dtype), None
        if self.pointwise:
            if self.stride != 1:
                x = x[:, ::self.stride, ::self.stride]
            x = pointwise(x, weight, bias)
        else:
            x = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, conv.stride, conv.padding,
                         conv.dilation, conv.groups).permute(0, 2, 3, 1)
        if dtype is not None:
            x = x + conv.bias.to(dtype)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm == "batch_norm":
            x = batch_norm(self.norm_fn, x)
        elif self.norm == "instance_norm":
            x = instance_norm(x)
        return apply_activation(x, self.activation)


class MLP(nn.Module):
    """Stack of pointwise ConvNormAct layers (upstream MLP1d / MLP2d)."""

    def __init__(self, in_channels: int, mlps: Sequence[int], norm: Optional[str] = None,
                 activation: Optional[str] = "leaky_relu", n_spatial: int = 2):
        super().__init__()
        chans = [in_channels, *mlps]
        self.convs = nn.ModuleList(
            ConvNormAct(chans[i], chans[i + 1], norm=norm, activation=activation,
                        n_spatial=n_spatial) for i in range(len(mlps)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x
