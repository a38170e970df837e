"""RPEFlow core network (counterpart of rpeflow_tpu/model/core.py).

Two PWC branches (2-D image + event pyramids, 3-D point pyramid) fused by
MDTA cross-attention blocks, decoded coarse to fine. Channels-last
throughout. Attribute names follow the upstream module tree, so
``state_dict`` keys read ``pwc_fusion_core.pyramid_feat_fusers_2d.1...``;
the level-indexed ``ModuleList``s hold a parameter-free placeholder at
index 0, where the decode never goes.

``train`` (batch norm on batch statistics) makes the encode and the pyramid
fusers run per frame, as the reference applies them; at evaluation the two
frames share one stacked call, which is exact with running statistics.
``compute_mi`` adds the mutual-information terms of the six fusers, drawn
from the ``generator`` passed down. Each fuser returns ``(features, mi)``.
Gradients stop where the JAX package stops them (``stop_gradient`` there,
``.detach()`` here). The remat units of the JAX model are activation
checkpoints here: every ``CrossTransformerBlock`` and the convex upsampler.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nn.layers import ConvNormAct, conv2d_nhwc, pointwise
from ..nn.mdta import CrossTransformerBlock
from ..nn.mutual_info import MutualInfoReg
from ..nn.pyramid2d import ContextNetwork2D, FeaturePyramid2D, FlowEstimator2D, UpMaskHead2D
from ..nn.pyramid3d import Correlation3D, FeaturePyramid3D, FlowEstimator3D
from ..ops.correlation import correlation2d
from ..ops.geometry import CameraInfo, project_feat_with_nn_corr, project_pc2image
from ..ops.interp import (
    backwarp_3d,
    convex_upsample,
    device_constant,
    knn_interpolation,
    resize_bilinear_ac,
)
from ..ops.knn import k_nearest_neighbor
from ..ops.sample import backwarp_2d, grid_sample_2d, mesh_grid
from ..utils.profile import span


def _no_mi(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


class PyramidFeatureFuser2D(nn.Module):
    """3-D -> 2-D pyramid fusion."""

    def __init__(self, c2d: int, c3d: int, num_heads: int, norm: Optional[str]):
        super().__init__()
        self.mlps = nn.ModuleList([ConvNormAct(3 + c3d, c2d, norm=norm)])
        self.mi = MutualInfoReg(c2d, c2d // 2, 2, n_spatial=2)
        self.fuse = CrossTransformerBlock(c2d, num_heads, n_spatial=2)

    def forward(self, xy, feat_2d, feat_3d, nn_proj, compute_mi=False, generator=None):
        out = self.mlps[0](project_feat_with_nn_corr(xy, feat_2d, feat_3d, nn_proj[..., 0]))
        mi = self.mi(feat_2d, out, generator=generator) if compute_mi else _no_mi(out)
        return self.fuse(feat_2d, out), mi


class PyramidFeatureFuser3D(nn.Module):
    """2-D -> 3-D pyramid fusion."""

    def __init__(self, c2d: int, c3d: int, num_heads: int, norm: Optional[str]):
        super().__init__()
        self.mlps = nn.ModuleList([ConvNormAct(c2d, c3d, norm=norm, n_spatial=1)])
        self.mi = MutualInfoReg(c3d, c3d // 2, 2, n_spatial=1)
        self.fuse = CrossTransformerBlock(c3d, num_heads, n_spatial=1)

    def forward(self, xy, feat_2d, feat_3d, compute_mi=False, generator=None):
        out = self.mlps[0](grid_sample_2d(feat_2d, xy, "zeros").detach())
        mi = self.mi(feat_3d, out, generator=generator) if compute_mi else _no_mi(out)
        return self.fuse(feat_3d, out), mi


class CorrFeatureFuser2D(nn.Module):
    """Correlation fusion 3-D -> 2-D, where the event features enter."""

    def __init__(self, corr_ch: int, c3d: int, c_event: int, num_heads: int):
        super().__init__()
        proj_ch = 3 + c3d + 2
        self.head_3d = ConvNormAct(proj_ch, corr_ch)
        self.head_event = ConvNormAct(c_event, corr_ch)
        self.mi = MutualInfoReg(corr_ch, corr_ch // 2, 3, n_spatial=2)
        self.mlps = nn.ModuleList([ConvNormAct(proj_ch + c_event, c3d + corr_ch),
                                   ConvNormAct(c3d + corr_ch, corr_ch)])
        self.fuse = CrossTransformerBlock(corr_ch, num_heads, n_spatial=2)

    def forward(self, xy, feat_2d, feat_3d, efeat_2d, last_flow_2d, last_flow_3d_to_2d,
                nn_proj, compute_mi=False, generator=None):
        feat_3d = torch.cat([feat_3d, last_flow_3d_to_2d.to(feat_3d.dtype)], dim=-1)
        f32d = project_feat_with_nn_corr(xy, feat_2d, feat_3d, nn_proj[..., 0])
        f32d = torch.cat([f32d[..., :-2], f32d[..., -2:] - last_flow_2d.detach()], dim=-1)
        if compute_mi:
            mi = self.mi(feat_2d, self.head_3d(f32d), self.head_event(efeat_2d),
                         generator=generator)
        else:
            mi = _no_mi(f32d)
        out = self.mlps[1](self.mlps[0](torch.cat([f32d, efeat_2d], dim=-1)))
        return self.fuse(feat_2d, out), mi


class CorrFeatureFuser3D(nn.Module):
    """Correlation fusion 2-D -> 3-D, where the event features enter."""

    def __init__(self, corr_ch: int, c3d: int, c_event: int, num_heads: int):
        super().__init__()
        self.head_2d = ConvNormAct(corr_ch + 2, c3d, n_spatial=1)
        self.mi = MutualInfoReg(c3d, c3d // 2, 3, n_spatial=1)
        self.mlps = nn.ModuleList([
            ConvNormAct(corr_ch + 2 + c_event, corr_ch + c3d, n_spatial=1),
            ConvNormAct(corr_ch + c3d, c3d, n_spatial=1)])
        self.fuse = CrossTransformerBlock(c3d, num_heads, n_spatial=1)

    def forward(self, xy, feat_corr_2d, feat_corr_3d, efeat_2d, last_flow_3d,
                last_flow_2d_to_3d, compute_mi=False, generator=None):
        feat = torch.cat([feat_corr_2d, last_flow_2d_to_3d.to(feat_corr_2d.dtype)], dim=-1)
        f23 = grid_sample_2d(feat, xy, "zeros")
        e23 = grid_sample_2d(efeat_2d, xy, "zeros").detach()
        f23 = torch.cat([f23[..., :-2], f23[..., -2:] - last_flow_3d[..., :2]], dim=-1).detach()
        if compute_mi:
            mi = self.mi(feat_corr_3d, self.head_2d(f23), e23, generator=generator)
        else:
            mi = _no_mi(f23)
        out = self.mlps[1](self.mlps[0](torch.cat([f23, e23], dim=-1)))
        return self.fuse(feat_corr_3d, out), mi


class DecoderFeatureFuser2D(nn.Module):
    """Decoder fusion 3-D -> 2-D."""

    def __init__(self, c2d: int, c3d: int, num_heads: int):
        super().__init__()
        self.mlps = nn.ModuleList([ConvNormAct(3 + c3d, c2d)])
        self.mi = MutualInfoReg(c2d, c2d // 2, 2, n_spatial=2)
        self.fuse = CrossTransformerBlock(c2d, num_heads, n_spatial=2)

    def forward(self, xy, feat_2d, feat_3d, nn_proj, compute_mi=False, generator=None):
        out = self.mlps[0](project_feat_with_nn_corr(xy, feat_2d, feat_3d, nn_proj[..., 0]))
        mi = self.mi(feat_2d, out, generator=generator) if compute_mi else _no_mi(out)
        return self.fuse(feat_2d, out), mi


class DecoderFeatureFuser3D(nn.Module):
    """Decoder fusion 2-D -> 3-D."""

    def __init__(self, c2d: int, c3d: int, num_heads: int):
        super().__init__()
        self.mlps = nn.ModuleList([ConvNormAct(c2d, c3d, n_spatial=1)])
        self.mi = MutualInfoReg(c3d, c3d // 2, 2, n_spatial=1)
        self.fuse = CrossTransformerBlock(c3d, num_heads, n_spatial=1)

    def forward(self, xy, feat_2d, feat_3d, compute_mi=False, generator=None):
        out = self.mlps[0](grid_sample_2d(feat_2d, xy, "zeros").detach())
        mi = self.mi(feat_3d, out, generator=generator) if compute_mi else _no_mi(out)
        return self.fuse(feat_3d, out), mi


# Per-level channel and head tables (upstream RPEFlow_core.py).
_CH = [16, 32, 64, 96, 128, 192]
_HEADS_PYR = [None, 1, 2, 2, 4, 4]
_HEADS_CORR_2D = [None, 1, 1, 3, 3, 3]
_HEADS_CORR_3D = [None, 1, 2, 2, 4, 4]


def _levels(make, n_levels: int) -> nn.ModuleList:
    """Level-indexed list with a parameter-free placeholder at level 0."""
    return nn.ModuleList([nn.Identity()] + [make(i) for i in range(1, n_levels)])


def level_scale(h: int, w: int, camera: CameraInfo, device) -> torch.Tensor:
    """The factor from the camera's sensor to a ``h x w`` decode level's
    pixels, ``[(w - 1) / (sensor_w - 1), (h - 1) / (sensor_h - 1)]``, on
    ``device`` (float32)."""
    sw, sh = camera.sensor_w, camera.sensor_h
    return device_constant(
        ("level_scale", h, w, sh, sw, device),
        lambda: torch.tensor([(w - 1) / (sw - 1), (h - 1) / (sh - 1)], dtype=torch.float32,
                             device=device))


class RPEFlowCore(nn.Module):
    """Encoder/decoder assembly. ``n_levels`` counts pyramid levels including
    level 0 (6 at full depth: the full cloud and 5 FPS levels, decoded over
    levels 5..1). ``amp`` runs the RGB and event 2-D pyramids in bfloat16
    (their norms in float32) and casts their outputs to float32, so that
    nothing else of the model computes in bfloat16."""

    def __init__(self, cfgs2d: Any, cfgs3d: Any, n_levels: int = 6, amp: bool = False):
        super().__init__()
        if not 2 <= n_levels <= 6:
            raise ValueError(f"n_levels must be in [2, 6], got {n_levels}")
        nl = n_levels
        self.max_displacement = int(cfgs2d.max_displacement)
        self.k = int(cfgs3d.k)
        corr_ch = (2 * self.max_displacement + 1) ** 2
        event_bins = cfgs2d.event_bins * 2 if cfgs2d.event_polarity else cfgs2d.event_bins
        # event pyramid channels per level: 32 at level 0, then _CH
        ev_ch = [32] + _CH[1:nl]

        pyr_dtype = torch.bfloat16 if amp else None
        self.feature_pyramid_2d = FeaturePyramid2D([3] + _CH[:nl],
                                                   norm=cfgs2d.norm.feature_pyramid,
                                                   dtype=pyr_dtype)
        self.efeature_pyramid_2d = FeaturePyramid2D([event_bins] + ev_ch,
                                                    norm=cfgs2d.norm.feature_pyramid,
                                                    dtype=pyr_dtype)
        self.feature_aligners_2d = _levels(lambda i: ConvNormAct(_CH[i], 64), nl)
        self.efeature_aligners_2d = _levels(lambda i: ConvNormAct(ev_ch[i], 64), nl)

        self.flow_estimator_2d = FlowEstimator2D(
            [64 + 64 + corr_ch + 2 + 32, 192, 128, 96, 64, 32],
            norm=cfgs2d.norm.flow_estimator)
        ff2d = self.flow_estimator_2d.flow_feat_dim
        self.context_network_2d = ContextNetwork2D(
            [ff2d + 2, 128, 128, 128, 96, 64, 32], dilations=[1, 2, 4, 8, 16, 1],
            norm=cfgs2d.norm.context_network)
        self.up_mask_head_2d = UpMaskHead2D(32)

        self.feature_pyramid_3d = FeaturePyramid3D(_CH[:nl], norm=cfgs3d.norm.feature_pyramid,
                                                   k=self.k)
        self.feature_aligners_3d = _levels(lambda i: ConvNormAct(_CH[i], 64, n_spatial=1), nl)
        self.correlations_3d = _levels(lambda i: Correlation3D(_CH[i], _CH[i], k=self.k), nl)
        self.correlation_aligners_3d = _levels(
            lambda i: ConvNormAct(_CH[i], 64, n_spatial=1), nl)
        self.flow_estimator_3d = FlowEstimator3D([64 + 64 + 3 + 64, 128, 128, 64],
                                                 norm=cfgs3d.norm.flow_estimator, k=self.k)

        self.pyramid_feat_fusers_2d = _levels(lambda i: PyramidFeatureFuser2D(
            _CH[i], _CH[i], _HEADS_PYR[i], cfgs2d.norm.feature_pyramid), nl)
        self.pyramid_feat_fusers_3d = _levels(lambda i: PyramidFeatureFuser3D(
            _CH[i], _CH[i], _HEADS_PYR[i], cfgs3d.norm.feature_pyramid), nl)
        self.corr_feat_fusers_2d = _levels(lambda i: CorrFeatureFuser2D(
            corr_ch, _CH[i], ev_ch[i], _HEADS_CORR_2D[i]), nl)
        self.corr_feat_fusers_3d = _levels(lambda i: CorrFeatureFuser3D(
            corr_ch, _CH[i], ev_ch[i], _HEADS_CORR_3D[i]), nl)
        self.estimator_feat_fuser_2d = DecoderFeatureFuser2D(ff2d, 64, 2)
        self.estimator_feat_fuser_3d = DecoderFeatureFuser3D(ff2d, 64, 2)

        self.conv_last_2d = nn.Conv2d(ff2d, 2, 3, padding=1)
        self.conv_last_3d = nn.Conv1d(64, 3, 1)

    def encode(self, image, xyzs):
        """One frame's image pyramid (float32 at its boundary) and point pyramid."""
        return ([f.float() for f in self.feature_pyramid_2d(image)],
                self.feature_pyramid_3d(xyzs))

    def encode_both(self, image1, image2, xyzs1, xyzs2):
        """Both frames through the shared pyramids as one 2B batch (exact at
        evaluation: batch norm uses running statistics)."""
        b = image1.shape[0]
        feats_2d, feats_3d = self.encode(
            torch.cat([image1, image2], dim=0),
            [torch.cat([x1, x2], dim=0) for x1, x2 in zip(xyzs1, xyzs2)])
        return ([f[:b] for f in feats_2d], [f[b:] for f in feats_2d],
                [f[:b] for f in feats_3d], [f[b:] for f in feats_3d])

    def encode_event(self, event_voxel):
        return [f.float() for f in self.efeature_pyramid_2d(event_voxel)]

    def decode_level(self, level: int, xyz1, xyz2, feat1_2d, feat2_2d, feat1_3d, feat2_3d,
                     efeat_2d, xyz1_up, camera: CameraInfo,
                     prev: Optional[Dict[str, torch.Tensor]] = None, train: bool = False,
                     compute_mi: bool = False,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One coarse-to-fine decode iteration; ``prev`` holds the coarser
        level's ``flow_2d``, ``flow_3d``, ``flow_feat_2d``, ``flow_feat_3d``
        (None at the coarsest level). The result also holds the level's MI
        sums ``mi2d`` and ``mi3d``."""
        b, h, w = feat1_2d.shape[:3]
        n_points = xyz1.shape[1]
        dev = feat1_2d.device
        scale = level_scale(h, w, camera, dev)
        xy1 = project_pc2image(xyz1, camera) * scale
        xy2 = project_pc2image(xyz2, camera) * scale

        xy_s = torch.cat([xy1, xy2], dim=0)
        grid = mesh_grid(h, w, device=dev).reshape(1, h * w, 2).expand(2 * b, h * w, 2)
        nn_proj = k_nearest_neighbor(xy_s, grid, 1)  # [2B, HW, 1]
        nn_proj1, nn_proj2 = nn_proj[:b], nn_proj[b:]
        knn_1in1 = k_nearest_neighbor(xyz1, xyz1, self.k)

        mi = dict(compute_mi=compute_mi, generator=generator)
        if not train and not compute_mi:
            f2d_s = torch.cat([feat1_2d, feat2_2d], dim=0)
            f3d_s = torch.cat([feat1_3d, feat2_3d], dim=0)
            fs_2d, mi2d_1 = self.pyramid_feat_fusers_2d[level](xy_s, f2d_s, f3d_s, nn_proj)
            fs_3d, mi3d_1 = self.pyramid_feat_fusers_3d[level](xy_s, f2d_s, f3d_s)
            mi2d_2, mi3d_2 = mi2d_1, mi3d_1
            feat1_2d, feat2_2d = fs_2d[:b], fs_2d[b:]
            feat1_3d, feat2_3d = fs_3d[:b], fs_3d[b:]
        else:
            fusers_2d, fusers_3d = self.pyramid_feat_fusers_2d[level], self.pyramid_feat_fusers_3d[level]
            f1_2d, mi2d_1 = fusers_2d(xy1, feat1_2d, feat1_3d, nn_proj1, **mi)
            f2_2d, mi2d_2 = fusers_2d(xy2, feat2_2d, feat2_3d, nn_proj2, **mi)
            f1_3d, mi3d_1 = fusers_3d(xy1, feat1_2d, feat1_3d, **mi)
            f2_3d, mi3d_2 = fusers_3d(xy2, feat2_2d, feat2_3d, **mi)
            feat1_2d, feat2_2d, feat1_3d, feat2_3d = f1_2d, f2_2d, f1_3d, f2_3d

        if prev is None:
            last_flow_2d = torch.zeros(b, h, w, 2, device=dev)
            last_flow_3d = torch.zeros(b, n_points, 3, device=dev)
            last_flow_feat_2d = torch.zeros(b, h, w, 32, device=dev)
            last_flow_feat_3d = torch.zeros(b, n_points, 64, device=dev)
            xyz2_warp, feat2_2d_warp = xyz2, feat2_2d
        else:
            last_flow_2d = resize_bilinear_ac(prev["flow_2d"] * 2.0, h, w)
            last_flow_feat_2d = resize_bilinear_ac(prev["flow_feat_2d"], h, w)
            feat2_2d_warp = backwarp_2d(feat2_2d, last_flow_2d, "border")
            up = knn_interpolation(
                xyz1_up, torch.cat([prev["flow_3d"], prev["flow_feat_3d"]], dim=-1), xyz1)
            last_flow_3d = up[..., :3]
            last_flow_feat_3d = up[..., 3:]
            xyz2_warp = backwarp_3d(xyz1, xyz2, last_flow_3d)

        feat_corr_3d = self.correlations_3d[level](xyz1, feat1_3d, xyz2_warp, feat2_3d,
                                                   knn_1in1)
        feat_corr_2d = F.leaky_relu(
            correlation2d(feat1_2d.float().contiguous(), feat2_2d_warp.float().contiguous(),
                          self.max_displacement), negative_slope=0.1)

        last_flow_3d_to_2d = last_flow_3d[..., :2] * scale
        last_flow_2d_to_3d = last_flow_2d / scale
        fc2d, mi2d_3 = self.corr_feat_fusers_2d[level](
            xy1, feat_corr_2d, feat_corr_3d, efeat_2d, last_flow_2d, last_flow_3d_to_2d,
            nn_proj1, **mi)
        fc3d, mi3d_3 = self.corr_feat_fusers_3d[level](
            xy1, feat_corr_2d, feat_corr_3d, efeat_2d, last_flow_3d, last_flow_2d_to_3d, **mi)

        feat1_2d = self.feature_aligners_2d[level](feat1_2d)
        feat1_3d = self.feature_aligners_3d[level](feat1_3d)
        efeat_al = self.efeature_aligners_2d[level](efeat_2d)
        feat_corr_3d = self.correlation_aligners_3d[level](fc3d)

        x_2d = torch.cat([fc2d, feat1_2d, efeat_al, last_flow_2d, last_flow_feat_2d], dim=-1)
        x_3d = torch.cat([feat_corr_3d, feat1_3d, last_flow_3d, last_flow_feat_3d], dim=-1)
        flow_feat_2d = self.flow_estimator_2d(x_2d)
        flow_feat_3d = self.flow_estimator_3d(xyz1, x_3d, knn_1in1)

        ff2d, mi2d_4 = self.estimator_feat_fuser_2d(xy1, flow_feat_2d, flow_feat_3d, nn_proj1,
                                                    **mi)
        ff3d, mi3d_4 = self.estimator_feat_fuser_3d(xy1, flow_feat_2d, flow_feat_3d, **mi)

        flow_2d = last_flow_2d + conv2d_nhwc(ff2d, self.conv_last_2d)
        flow_3d = last_flow_3d + pointwise(ff3d, self.conv_last_3d.weight, self.conv_last_3d.bias)
        flow_feat_2d, flow_delta_2d = self.context_network_2d(torch.cat([ff2d, flow_2d], dim=-1))
        return {
            "flow_2d": flow_2d + flow_delta_2d,
            "flow_3d": flow_3d,
            "flow_feat_2d": flow_feat_2d,
            "flow_feat_3d": ff3d,
            "last_flow_3d": last_flow_3d,
            "mi2d": mi2d_1 + mi2d_2 + mi2d_3 + mi2d_4,
            "mi3d": mi3d_1 + mi3d_2 + mi3d_3 + mi3d_4,
        }

    def _convex_upsample(self, flow_feat, flow):
        return convex_upsample(flow, self.up_mask_head_2d(flow_feat), 4)

    def decode_post(self, flows_2d, flows_3d, flow_feat_2d_finest, xyzs1, up_flow_cache):
        """Final upsampling; lists arrive coarse -> fine and return fine ->
        coarse at output resolution. ``up_flow_cache[level]`` is that level's
        ``last_flow_3d``, the interpolation the finest upsample would redo."""
        flows_2d = list(flows_2d)[::-1]
        flows_3d = list(flows_3d)[::-1]
        if torch.is_grad_enabled():
            # the upsampler draws no random number, so the recompute needs no
            # RNG state (stashing it would read the generator inside a capture)
            flows_2d[0] = checkpoint(self._convex_upsample, flow_feat_2d_finest, flows_2d[0],
                                     use_reentrant=False, preserve_rng_state=False)
        else:
            flows_2d[0] = self._convex_upsample(flow_feat_2d_finest, flows_2d[0])
        for i in range(1, len(flows_2d)):
            h, w = flows_2d[i].shape[1:3]
            flows_2d[i] = resize_bilinear_ac(flows_2d[i] * 4.0, h * 4, w * 4)
        for i in range(len(flows_3d)):
            flows_3d[i] = (up_flow_cache[i] if i in up_flow_cache
                           else knn_interpolation(xyzs1[i + 1], flows_3d[i], xyzs1[i]))
        return flows_2d, flows_3d

    def decode(self, xyzs1, xyzs2, feats1_2d, feats2_2d, feats1_3d, feats2_3d, efeats_2d,
               camera: CameraInfo, train: bool = False, compute_mi: bool = False,
               generator: Optional[torch.Generator] = None):
        """Levels ``len(xyzs1)-1 .. 1``; returns (flows_2d, flows_3d, mi_loss),
        flows fine -> coarse, ``mi_loss = sum (10 mi2d + mi3d) 0.85^(level-1)``.
        Profiler spans: ``rpeflow.forward.decode`` around it, ``.level<k>``
        around each level's :meth:`decode_level`, ``.post`` around
        :meth:`decode_post`."""
        with span("rpeflow.forward.decode"):
            flows_2d: List[torch.Tensor] = []
            flows_3d: List[torch.Tensor] = []
            up_flow_cache: Dict[int, torch.Tensor] = {}
            mi_loss = torch.zeros((), device=feats1_2d[-1].device)
            prev = None
            for level in range(len(xyzs1) - 1, 0, -1):
                with span(f"rpeflow.forward.decode.level{level}"):
                    out = self.decode_level(
                        level, xyzs1[level], xyzs2[level], feats1_2d[level], feats2_2d[level],
                        feats1_3d[level], feats2_3d[level], efeats_2d[level],
                        xyzs1[level + 1] if prev is not None else None, camera, prev=prev,
                        train=train, compute_mi=compute_mi, generator=generator)
                if prev is not None:
                    up_flow_cache[level] = out["last_flow_3d"]
                flows_2d.append(out["flow_2d"])
                flows_3d.append(out["flow_3d"])
                if compute_mi:
                    mi_loss = mi_loss + (10.0 * out["mi2d"] + out["mi3d"]) * (0.85 ** (level - 1))
                prev = out
            with span("rpeflow.forward.decode.post"):
                flows_2d, flows_3d = self.decode_post(flows_2d, flows_3d, prev["flow_feat_2d"],
                                                      xyzs1, up_flow_cache)
            return flows_2d, flows_3d, mi_loss
