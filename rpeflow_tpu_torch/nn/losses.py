"""Supervised multi-scale 2-D / 3-D flow losses (counterpart of
rpeflow_tpu/nn/losses.py). Channels-last: flow_2d ``[B, H, W, 2|3]``,
flow_3d ``[B, N, 3|4]``; a last extra target channel is a validity mask.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.gather import batch_gather
from ..ops.interp import resize_flow2d


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over elements where mask (torch ``x[mask].mean()``, 0 if empty)."""
    m = mask.float()
    return (x.float() * m).sum() / torch.clamp(m.sum(), min=1.0)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's gradient at 0 (+1; ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite (zero) gradient at exactly-zero vectors:
    ``sqrt(max(s, 1e-16))`` moves values by at most 1e-8."""
    return torch.sqrt(torch.clamp((x * x).sum(dim), min=1e-16))


def _level_weights(cfg, n: int) -> Sequence[float]:
    lw = getattr(cfg, "level_weights", None)
    if lw is not None and lw != "None":
        if n > len(lw):
            raise ValueError(f"{n} levels but {len(lw)} level weights")
        return lw
    decay = cfg.iters_weight_decay
    return [decay ** i for i in range(n)]


def supervised_loss_2d(flows, target: torch.Tensor, cfg) -> torch.Tensor:
    """Multi-scale robust-L1 or L2 flow loss; each prediction is resized,
    with its magnitude rescaled, to the target resolution."""
    if cfg.order not in ("l1", "l2"):
        raise NotImplementedError(cfg.order)
    weights = _level_weights(cfg, len(flows))
    th, tw = target.shape[1:3]
    if target.shape[-1] == 3:
        mask = target[..., 2] > 0
    else:
        mask = torch.ones(target.shape[:3], dtype=torch.bool, device=target.device)
    tgt = target[..., :2].float()
    total = 0.0
    for pred, w in zip(flows, weights):
        diff = _abs(resize_flow2d(pred.float(), th, tw) - tgt)
        if cfg.order == "l1":
            loss_map = torch.pow(diff.sum(-1) + 0.01, 0.4)
        else:
            loss_map = _safe_norm(diff)
        total = total + w * _masked_mean(loss_map, mask)
    return total


def supervised_loss_3d(flows, target: torch.Tensor, cfg, indices) -> torch.Tensor:
    """Multi-scale scene-flow loss; ``indices[i]`` maps the full-resolution
    target onto level i's points."""
    if cfg.order not in ("l1", "l2"):
        raise NotImplementedError(cfg.order)
    weights = _level_weights(cfg, len(flows))
    total = 0.0
    for i, (flow, w) in enumerate(zip(flows, weights)):
        level_target = target if target.shape[1] == flow.shape[1] else batch_gather(
            target, indices[i])
        level_target = level_target.float()
        flow = flow.float()
        if level_target.shape[-1] == 4:
            mask = level_target[..., 3] > 0
            diff = flow - level_target[..., :3]
            epe_l1 = _masked_mean(torch.pow(_abs(diff).sum(-1) + 0.01, 0.4), mask)
            epe_l2 = _masked_mean(_safe_norm(diff), mask)
        else:
            diff = flow - level_target
            epe_l1 = torch.pow(_abs(diff).sum(-1) + 0.01, 0.4).mean()
            epe_l2 = _safe_norm(diff).mean()
        total = total + w * (epe_l1 if cfg.order == "l1" else epe_l2)
    return total
