"""PointConv (counterpart of rpeflow_tpu/nn/pointconv.py), channels-last."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.gather import batch_gather
from ..ops.knn import k_nearest_neighbor
from .layers import MLP, apply_activation, batch_norm, instance_norm


class PointConv(nn.Module):
    """Weight-net point convolution, optionally downsampling onto
    ``sampled_xyz``. ``in_channels`` counts the features without xyz."""

    def __init__(self, in_channels: int, out_channels: int, norm: Optional[str] = None,
                 activation: str = "leaky_relu", k: int = 16):
        super().__init__()
        self.k = k
        self.norm = norm
        self.activation = activation
        self.weight_net = MLP(3, [8, 16], activation=activation, n_spatial=2)
        self.linear = nn.Linear(16 * (3 + in_channels), out_channels)
        if norm == "batch_norm":
            self.norm_fn = nn.BatchNorm1d(out_channels)
        elif norm not in (None, "instance_norm"):
            raise NotImplementedError(norm)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                sampled_xyz: Optional[torch.Tensor] = None,
                knn_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        if sampled_xyz is None:
            sampled_xyz = xyz
        features = torch.cat([xyz.to(features.dtype), features], dim=-1)
        if knn_indices is not None:
            knn_indices = knn_indices[:, :, :self.k]
        else:
            knn_indices = k_nearest_neighbor(xyz, sampled_xyz, self.k)
        knn_features = batch_gather(features, knn_indices)     # [B, S, k, 3+C]
        knn_xyz_norm = knn_features[..., :3].float() - sampled_xyz[:, :, None, :]
        weights = self.weight_net(knn_xyz_norm.to(features.dtype))  # [B, S, k, 16]
        weighted = torch.einsum("bskw,bskc->bswc", weights, knn_features)
        b, s = weighted.shape[:2]
        out = self.linear(weighted.reshape(b, s, -1))  # weight-major (w, c)
        if self.norm == "batch_norm":
            out = batch_norm(self.norm_fn, out)
        elif self.norm == "instance_norm":
            out = instance_norm(out)
        return apply_activation(out, self.activation)
