"""The training step, Adam and the evaluator's metric sums, plain PyTorch, one
process (frozen copies of ``rpeflow_tpu_torch/train/state.py : train_step``,
of ``train/optim.py``'s Adam over its parameter groups, and of
``train/evaluator.py : _metric_sums``).

:class:`Adam` writes out ``torch.optim.Adam``'s update (betas 0.9, 0.999, the
L2 decay added to the gradient, the bias corrections) at a constant learning
rate, over the groups of ``train/optim.py : param_groups``: a parameter whose
last name component is ``weight`` decays by ``weight_decay``, ``bias`` by
``bias_decay``, and the rest (the MDTA ``temperature``) never moves.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn


class Adam:
    def __init__(self, model: nn.Module, lr: float, weight_decay: float, bias_decay: float,
                 eps: float = 1e-7, betas=(0.9, 0.999)):
        self.lr, self.eps, self.betas = float(lr), float(eps), betas
        self.params: List[tuple] = []  # (name, parameter, decay)
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight", "bias"):
                self.params.append((name, p, float(weight_decay if leaf == "weight"
                                                   else bias_decay)))
        self.m = [torch.zeros_like(p) for _, p, _ in self.params]
        self.v = [torch.zeros_like(p) for _, p, _ in self.params]
        self.t = [0] * len(self.params)  # a parameter's updates, as torch counts them

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update of every parameter that has a gradient; returns each
        one's gradient as the update takes it (its decay added), by name."""
        b1, b2 = self.betas
        used = {}
        for i, ((name, p, decay), m, v) in enumerate(zip(self.params, self.m, self.v)):
            if p.grad is None:
                continue
            self.t[i] += 1
            g = p.grad if decay == 0.0 else p.grad + decay * p
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step_size = self.lr / (1 - b1 ** self.t[i])
            root2 = math.sqrt(1 - b2 ** self.t[i])
            p.sub_(step_size * m / (torch.sqrt(v) / root2 + self.eps))
            used[name] = g
        return used


def train_step(model: nn.Module, opt: Adam, batch: Dict[str, torch.Tensor],
               generator: torch.Generator, compute_mi: bool = True):
    """One step on ``batch`` with the model in training mode: forward with
    the losses (MI noise from ``generator``), backward, update. Returns
    ``(loss, gradients as the update took them)``."""
    model.zero_grad(set_to_none=True)
    _, aux = model(batch, compute_mi=compute_mi, compute_loss=True, generator=generator)
    aux["loss"].backward()
    used = opt.step()
    return float(aux["loss"].detach()), used


#: the keys of :func:`metric_sums`, in its order
SUM_KEYS = ("2d/counts", "2d/EPE2d", "2d/1px", "2d/Fl", "3d/counts", "3d/EPE3d", "3d/5cm",
            "3d/10cm")
NOC_SUM_KEYS = ("3dnoc/counts", "3dnoc/EPE3d", "3dnoc/5cm", "3dnoc/10cm")


def metric_sums(outputs, batch, with_occ: bool) -> Dict[str, torch.Tensor]:
    """Metric sums and counts for one batch (0-d tensors)."""
    pred2d = outputs["flow_2d"].float()
    pred3d = outputs["flow_3d"].float()
    t2d = batch["flow_2d"].float()
    t3d = batch["flow_3d"].float()
    if t2d.shape[-1] > 2:
        mask2d = t2d[..., 2] > 0
        t2d = t2d[..., :2]
    else:
        mask2d = torch.ones(t2d.shape[:3], dtype=torch.bool, device=t2d.device)
    if t3d.shape[-1] > 3:
        mask3d = t3d[..., 3] > 0
        t3d = t3d[..., :3]
    else:
        mask3d = torch.ones(t3d.shape[:2], dtype=torch.bool, device=t3d.device)

    epe2d = torch.linalg.norm(pred2d - t2d, dim=-1)
    epe3d = torch.linalg.norm(pred3d - t3d, dim=-1)
    mask2d = mask2d & ~torch.isnan(epe2d)
    mask3d = mask3d & ~torch.isnan(epe3d)
    m2 = mask2d.float()
    m3 = mask3d.float()
    mag = torch.linalg.norm(t2d, dim=-1)
    fl = ((epe2d > 3.0) & (epe2d / mag > 0.05)).float()
    zero = torch.zeros((), device=epe2d.device)
    out = {
        "2d/counts": m2.sum(),
        "2d/EPE2d": torch.where(mask2d, epe2d, zero).sum(),
        "2d/1px": ((epe2d < 1.0) * m2).sum(),
        "2d/Fl": (fl * m2).sum(),
        "3d/counts": m3.sum(),
        "3d/EPE3d": torch.where(mask3d, epe3d, zero).sum(),
        "3d/5cm": ((epe3d < 0.05) * m3).sum(),
        "3d/10cm": ((epe3d < 0.1) * m3).sum(),
    }
    if with_occ:
        noc = (batch["occ_mask_3d"] == 0) & mask3d
        mn = noc.float()
        out.update({
            "3dnoc/counts": mn.sum(),
            "3dnoc/EPE3d": torch.where(noc, epe3d, zero).sum(),
            "3dnoc/5cm": ((epe3d < 0.05) * mn).sum(),
            "3dnoc/10cm": ((epe3d < 0.1) * mn).sum(),
        })
    return out
