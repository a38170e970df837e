"""2-D (IRR-PWC) branch (counterpart of rpeflow_tpu/nn/pyramid2d.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_nhwc
from .layers import ConvNormAct, conv2d_nhwc, pointwise


class ResidualBlock(nn.Module):
    """Stride-2 residual block; its convs compute in ``dtype`` (see
    :class:`ConvNormAct`)."""

    def __init__(self, in_channels: int, out_channels: int, norm: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down0 = ConvNormAct(in_channels, out_channels, 1, stride=2, norm=norm,
                                 activation=None, dtype=dtype)
        self.conv0 = ConvNormAct(in_channels, out_channels, 3, stride=2, padding=1,
                                 norm=norm, dtype=dtype)
        self.conv1 = ConvNormAct(out_channels, out_channels, 3, padding=1, norm=norm,
                                 activation=None, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down = self.down0(x)
        out = self.conv1(self.conv0(x))
        return F.leaky_relu(out + down, negative_slope=0.1)


class FeaturePyramid2D(nn.Module):
    """Stride-2 pyramid: ``n_channels[0]`` input channels, one block per
    following entry; returns every block's output, in ``dtype`` if one is
    given (the ``amp`` scope)."""

    def __init__(self, n_channels: Sequence[int], norm: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pyramid_convs = nn.ModuleList(
            ResidualBlock(n_channels[i], n_channels[i + 1], norm, dtype)
            for i in range(len(n_channels) - 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for block in self.pyramid_convs:
            x = block(x)
            outputs.append(x)
        return outputs


class DecoderConv(ConvNormAct):
    """A 3x3, stride-1 conv block of the 2-D decoder (dilation and zero
    padding ``dilation``): its conv goes through
    :func:`~rpeflow_tpu_torch.ops.conv3x3.conv3x3_nhwc`, the hand-written
    kernel on the card (the encoder's convs stay on ``F.conv2d``)."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 1,
                 norm: Optional[str] = None):
        super().__init__(in_channels, out_channels, 3, padding=dilation, dilation=dilation,
                         norm=norm)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv_fn
        return conv3x3_nhwc(x, conv.weight, conv.bias, conv.dilation[0])


class FlowEstimator2D(nn.Module):
    """Five 3x3 convs; returns ``[conv5 | conv4]`` features."""

    def __init__(self, n_channels: Sequence[int], norm: Optional[str] = None):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", DecoderConv(n_channels[i], n_channels[i + 1],
                                                        norm=norm))
        self.flow_feat_dim = n_channels[4] + n_channels[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
        return torch.cat([self.conv5(x), x], dim=-1)


class ContextNetwork2D(nn.Module):
    """Dilated-conv context refinement; returns ``(features, flow delta)``."""

    def __init__(self, n_channels: Sequence[int], dilations: Sequence[int],
                 norm: Optional[str] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            DecoderConv(n_channels[i], n_channels[i + 1], dil, norm=norm)
            for i, dil in enumerate(dilations))
        self.conv_last = nn.Conv2d(n_channels[-1], 2, 3, padding=1)

    def forward(self, x: torch.Tensor):
        for conv in self.convs:
            x = conv(x)
        return x, conv2d_nhwc(x, self.conv_last)


class UpMaskHead2D(nn.Sequential):
    """RAFT convex-upsample mask head: 3x3 conv, ReLU, 1x1 conv (indices 0, 2
    as in the upstream ``nn.Sequential``)."""

    def __init__(self, in_channels: int, scale_factor: int = 4, hidden: int = 256):
        super().__init__(nn.Conv2d(in_channels, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, scale_factor * scale_factor * 9, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv2d_nhwc(x, self[0]))
        return pointwise(x, self[2].weight, self[2].bias)
