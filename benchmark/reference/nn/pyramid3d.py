"""3-D (Point-PWC) branch (frozen copy of rpeflow_tpu_torch/nn/pyramid3d.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.fps import furthest_point_sampling
from ..ops.gather import batch_gather, batch_gather_xyz_feat
from ..ops.knn import k_nearest_neighbor
from .layers import MLP
from .pointconv import PointConv


def build_pc_pyramid(pc1: torch.Tensor, pc2: torch.Tensor, n_samples_list: Sequence[int]):
    """One FPS of ``max(n_samples)`` over both clouds stacked on the batch
    axis, prefix-sliced per level. Returns ``(xyzs1, xyzs2, indices1,
    indices2)``; level 0 is the full cloud."""
    b, n, _ = pc1.shape
    idx_both = furthest_point_sampling(torch.cat([pc1, pc2], dim=0).contiguous(),
                                       max(n_samples_list)).long()
    idx1, idx2 = idx_both[:b], idx_both[b:]
    lv0 = torch.arange(n, device=pc1.device)[None].expand(b, n)
    xyzs1, xyzs2, indices1, indices2 = [pc1], [pc2], [lv0], [lv0]
    for n_samples in n_samples_list:
        indices1.append(idx1[:, :n_samples])
        indices2.append(idx2[:, :n_samples])
        xyzs1.append(batch_gather(pc1, idx1[:, :n_samples]))
        xyzs2.append(batch_gather(pc2, idx2[:, :n_samples]))
    return xyzs1, xyzs2, indices1, indices2


class FeaturePyramid3D(nn.Module):
    """Point feature pyramid; level-0 features come from an MLP over zeros."""

    def __init__(self, n_channels: Sequence[int], norm: Optional[str] = None, k: int = 16):
        super().__init__()
        ch = list(n_channels)
        self.level0_mlp = MLP(3, [ch[0], ch[0]], n_spatial=1)
        self.pyramid_mlps = nn.ModuleList(
            MLP(ch[i], [ch[i], ch[i + 1]], n_spatial=1) for i in range(len(ch) - 1))
        self.pyramid_convs = nn.ModuleList(
            PointConv(ch[i + 1], ch[i + 1], norm=norm, k=k) for i in range(len(ch) - 1))

    def forward(self, xyzs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        feats = [self.level0_mlp(torch.zeros_like(xyzs[0]))]
        for i, (mlp, conv) in enumerate(zip(self.pyramid_mlps, self.pyramid_convs)):
            feats.append(conv(xyzs[i], mlp(feats[-1]), sampled_xyz=xyzs[i + 1]))
        return feats


class Correlation3D(nn.Module):
    """Learned two-hop point cost volume."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 16):
        super().__init__()
        self.k = k
        self.cost_mlp = MLP(2 * in_channels + 3, [out_channels, out_channels])
        self.weight_net2 = MLP(3, [8, 8, out_channels], activation="relu")
        self.weight_net1 = MLP(3, [8, 8, out_channels], activation="relu")

    def forward(self, xyz1, feat1, xyz2, feat2, knn_indices_1in1=None):
        b, n, c = feat1.shape
        knn_1in2 = k_nearest_neighbor(xyz2, xyz1, self.k)
        knn_xyz2, knn_feat2 = batch_gather_xyz_feat(xyz2, feat2, knn_1in2)
        knn_xyz2_norm = (knn_xyz2 - xyz1[:, :, None, :]).to(feat1.dtype)
        feat1_exp = feat1[:, :, None, :].expand(b, n, self.k, c)
        p2p_cost = self.cost_mlp(torch.cat([feat1_exp, knn_feat2, knn_xyz2_norm], dim=-1))
        p2n_cost = (self.weight_net2(knn_xyz2_norm) * p2p_cost).sum(2)
        if knn_indices_1in1 is None:
            knn_indices_1in1 = k_nearest_neighbor(xyz1, xyz1, self.k)
        knn_xyz1, n2n = batch_gather_xyz_feat(xyz1, p2n_cost, knn_indices_1in1)
        knn_xyz1_norm = (knn_xyz1 - xyz1[:, :, None, :]).to(feat1.dtype)
        return (self.weight_net1(knn_xyz1_norm) * n2n).sum(2)


class FlowEstimator3D(nn.Module):
    """Two PointConvs and an MLP."""

    def __init__(self, n_channels: Sequence[int], norm: Optional[str] = None, k: int = 16):
        super().__init__()
        self.point_conv1 = PointConv(n_channels[0], n_channels[1], norm=norm, k=k)
        self.point_conv2 = PointConv(n_channels[1], n_channels[2], norm=norm, k=k)
        self.mlp = MLP(n_channels[2], [n_channels[2], n_channels[3]], n_spatial=1)

    def forward(self, xyz, feat, knn_indices):
        feat = self.point_conv1(xyz, feat, knn_indices=knn_indices)
        feat = self.point_conv2(xyz, feat, knn_indices=knn_indices)
        return self.mlp(feat)
