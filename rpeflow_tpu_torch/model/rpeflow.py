"""RPEFlow forward, losses and metrics (counterpart of
rpeflow_tpu/model/rpeflow.py).

Inputs are channels-last tensors on one device:
  images       [B, H, W, 6]   uint8 or float, both frames stacked
  pcs          [B, N, 6]      pc1 | pc2
  event_voxel  [B, H, W, 2*bins]
  intrinsics   [B, 3]         (f, cx, cy)
  flow_2d      [B, H, W, 2|3] target (loss only; 3rd channel = valid mask)
  flow_3d      [B, N, 3|4]    target (loss only; 4th channel = valid mask)
The config is read by attribute access only, so a YAML ``ConfigNode`` and a
nested ``SimpleNamespace`` both work.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..nn.losses import supervised_loss_2d, supervised_loss_3d
from ..nn.pyramid3d import build_pc_pyramid
from ..ops.geometry import CameraInfo, parallel2perspect, perspect2parallel
from ..ops.interp import resize_flow2d, resize_to_64x
from ..utils.profile import span
from .core import RPEFlowCore

DEFAULT_N_SAMPLES = (4096, 2048, 1024, 512, 256)


class RPEFlow(nn.Module):
    """Joint 2-D optical flow + 3-D scene flow model.

    It is built in eval mode. In training mode (``.train()``) batch norm
    uses batch statistics and the frames are encoded and fused one at a
    time, as in the reference; with ``cfgs.freeze_bn`` the batch norms stay
    in eval mode and the model computes as at evaluation. ``amp`` (the
    training config's ``amp: true``) runs the two 2-D feature pyramids in
    bfloat16 and nothing else (:class:`RPEFlowCore`).
    """

    def __init__(self, cfgs: Any, n_samples_list: Sequence[int] = DEFAULT_N_SAMPLES,
                 amp: bool = False):
        super().__init__()
        self.cfgs = cfgs
        self.n_samples_list = tuple(n_samples_list)
        self.amp = amp
        self.pwc_fusion_core = RPEFlowCore(cfgs.pwc2d, cfgs.pwc3d,
                                           n_levels=len(self.n_samples_list) + 1, amp=amp)
        self.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and getattr(self.cfgs, "freeze_bn", False):
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def _cameras(self, inputs):
        origin_h, origin_w = inputs["images"].shape[1:3]
        h64, w64 = -(-origin_h // 64) * 64, -(-origin_w // 64) * 64
        intr = inputs["intrinsics"].float()
        persp = CameraInfo("perspective", origin_h, origin_w, intr[:, 0], intr[:, 1],
                           intr[:, 2])
        if not self.cfgs.ids.enabled:
            return persp, None, persp
        div = self.cfgs.ids.sensor_size_divisor
        ph, pw = h64 // div, w64 // div
        paral = CameraInfo("parallel", ph, pw, None, (pw - 1) / 2, (ph - 1) / 2)
        return persp, paral, paral

    def forward(self, inputs: Dict[str, torch.Tensor], compute_mi: bool = False,
                compute_loss: bool = False, generator: Optional[torch.Generator] = None):
        """Returns ``{"flow_2d", "flow_3d"}``; with ``compute_loss`` (and
        targets in ``inputs``), ``(outputs, {"loss": loss, "scalar_summary":
        {...}})`` as the JAX model does. ``compute_mi`` adds the MI
        regulariser, its noise drawn from ``generator``. The forward runs in
        the profiler span ``rpeflow.forward``, its stages in
        ``rpeflow.forward.<stage>`` (:func:`..utils.profile.span`)."""
        with span("rpeflow.forward"):
            train = self.training and not getattr(self.cfgs, "freeze_bn", False)
            images = inputs["images"].float() / 255.0
            pc1 = inputs["pcs"][..., :3].float()
            pc2 = inputs["pcs"][..., 3:].float()
            event_voxel = resize_to_64x(inputs["event_voxel"].float())
            origin_h, origin_w = images.shape[1:3]
            images = resize_to_64x(images)
            image1, image2 = images[..., :3], images[..., 3:]

            persp, paral, decode_cam = self._cameras(inputs)
            ids = self.cfgs.ids.enabled
            if ids:
                pc1 = perspect2parallel(pc1, persp, paral)
                pc2 = perspect2parallel(pc2, persp, paral)

            core = self.pwc_fusion_core
            with span("rpeflow.forward.pyramid3d"):
                xyzs1, xyzs2, indices1, _ = build_pc_pyramid(pc1, pc2, self.n_samples_list)
            with span("rpeflow.forward.encode"):
                if train:
                    feats1_2d, feats1_3d = core.encode(image1, xyzs1)
                    feats2_2d, feats2_3d = core.encode(image2, xyzs2)
                else:
                    feats1_2d, feats2_2d, feats1_3d, feats2_3d = core.encode_both(
                        image1, image2, xyzs1, xyzs2)
            with span("rpeflow.forward.encode_event"):
                efeats_2d = core.encode_event(event_voxel)
            flows_2d, flows_3d, mi_loss = core.decode(
                xyzs1, xyzs2, feats1_2d, feats2_2d, feats1_3d, feats2_3d, efeats_2d, decode_cam,
                train=train, compute_mi=compute_mi, generator=generator)
            with span("rpeflow.forward.outputs"):
                if ids:
                    flows_3d = [parallel2perspect(xyz1 + f, persp, paral)
                                - parallel2perspect(xyz1, persp, paral)
                                for xyz1, f in zip(xyzs1, flows_3d)]
                outputs = {"flow_2d": resize_flow2d(flows_2d[0], origin_h, origin_w),
                           "flow_3d": flows_3d[0]}
            if not compute_loss or "flow_2d" not in inputs or "flow_3d" not in inputs:
                return outputs

            with span("rpeflow.forward.loss"):
                target_2d = inputs["flow_2d"].float()
                target_3d = inputs["flow_3d"].float()
                loss_2d = supervised_loss_2d(flows_2d, target_2d, self.cfgs.loss2d)
                loss_3d = supervised_loss_3d(flows_3d, target_3d, self.cfgs.loss3d,
                                             indices1) * 10.0
                final_mi_loss = mi_loss * 0.01
                loss = loss_2d + loss_3d + final_mi_loss
                summary = {"loss": loss.detach(), "loss_2d": loss_2d.detach(),
                           "loss_3d": loss_3d.detach(), "mi_loss": final_mi_loss.detach()}
                summary.update(flow_metrics(outputs["flow_2d"], outputs["flow_3d"], target_2d,
                                            target_3d))
            return outputs, {"loss": loss, "scalar_summary": summary}


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from one seeded generator (for runs
    with random weights). Conv and linear weights and biases are
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the scale of PyTorch's default
    initialisation (with larger weights, random flows compound into overflow
    over five decode levels); norms get weights near 1, small biases and
    means, variances in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if not t.is_floating_point():
                continue
            owner, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(owner)
            if leaf == "running_var":
                val = 0.5 + torch.rand(t.shape, generator=g)
            elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                val = (2 * torch.rand(t.shape, generator=g) - 1) / mod.weight[0].numel() ** 0.5
            elif leaf in ("weight", "temperature"):
                val = 1.0 + 0.1 * torch.randn(t.shape, generator=g)
            else:
                val = 0.1 * torch.randn(t.shape, generator=g)
            t.copy_(val)
    return model


@torch.no_grad()
def flow_metrics(flow_2d: torch.Tensor, flow_3d: torch.Tensor, target_2d: torch.Tensor,
                 target_3d: torch.Tensor) -> Dict[str, torch.Tensor]:
    """EPE / accuracy / outlier metrics: batch mean of per-sample masked
    means, without gradient."""
    flow_2d = flow_2d.float()
    flow_3d = flow_3d.float()
    if target_2d.shape[-1] == 3:
        m2d = (target_2d[..., 2] > 0).float()
        t2d = target_2d[..., :2]
    else:
        m2d = torch.ones(target_2d.shape[:3], device=target_2d.device)
        t2d = target_2d
    cnt2d = torch.clamp(m2d.sum((1, 2)), min=1.0)
    epe2d_map = torch.linalg.norm(flow_2d - t2d, dim=-1) * m2d
    mag = torch.linalg.norm(t2d, dim=-1) + 1e-5
    outlier = ((epe2d_map > 3.0) & (epe2d_map / mag > 0.05)).float() * m2d
    if target_3d.shape[-1] == 4:
        m3d = (target_3d[..., 3] > 0).float()
        t3d = target_3d[..., :3]
    else:
        m3d = torch.ones(target_3d.shape[:2], device=target_3d.device)
        t3d = target_3d
    cnt3d = torch.clamp(m3d.sum(1), min=1.0)
    epe3d_map = torch.linalg.norm(flow_3d - t3d, dim=-1) * m3d
    return {
        "epe2d": (epe2d_map.sum((1, 2)) / cnt2d).mean(),
        "acc2d_1px": (((epe2d_map < 1.0) * m2d).sum((1, 2)) / cnt2d).mean(),
        "outlier2d": (outlier.sum((1, 2)) / cnt2d).mean(),
        "epe3d": (epe3d_map.sum(1) / cnt3d).mean(),
        "acc3d_5cm": (((epe3d_map < 0.05) * m3d).sum(1) / cnt3d).mean(),
    }


def is_better(curr_summary: Optional[dict], best_summary: Optional[dict]) -> bool:
    """Checkpoint selection rule: a lower validation ``outlier2d``."""
    if best_summary is None:
        return True
    return float(curr_summary["outlier2d"]) < float(best_summary["outlier2d"])
