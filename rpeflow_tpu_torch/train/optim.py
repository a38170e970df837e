"""Optimizer and learning-rate schedules (counterpart of rpeflow_tpu/train/optim.py).

As upstream and in the JAX package:

* Adam with eps 1e-7 (or SGD with momentum), the decay added to the
  gradient (L2, not AdamW);
* parameters are grouped by the last component of their dotted name, the
  rule of ``rpeflow_tpu/train/optim.py:33-40 _group_of``: ``weight`` is in
  the ``weight_decay`` group, ``bias`` in the ``bias_decay`` group (the
  biases of the PointConv ``weight_net`` MLPs too), and the rest (only the
  MDTA ``temperature``) is in no group and never moves. It keeps
  ``requires_grad``, so its gradient still counts in the gradient norm;
* schedules are functions of the step counter: OneCycle per step (30%
  warm-up, cosine, div_factor 25, final_div_factor 1e4), Step/MultiStep per
  epoch (``step // steps_per_epoch``). The first update uses ``schedule(0)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn


def make_lr_schedule(cfgs, steps_per_epoch: int) -> Tuple[Callable[[int], float], str]:
    """``(schedule(step) -> lr, 'iter' | 'epoch')`` for the ``training`` block."""
    lr0 = float(cfgs.lr.init_value)
    if cfgs.lr.scheduler == "OneCycleLR":
        total = steps_per_epoch * cfgs.max_epochs
        if total <= 0:
            raise ValueError("OneCycleLR needs a positive number of steps")
        bounds = (0, int(0.3 * total), int(total))
        values = (lr0 / 25.0, lr0, lr0 / 25.0 / 1e4)

        def onecycle(step: int) -> float:
            for k in range(2):
                if bounds[k] <= step < bounds[k + 1]:
                    pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
                    start, end = values[k], values[k + 1]
                    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
            return values[2] if step >= bounds[2] else 0.0
        return onecycle, "iter"

    milestones = cfgs.lr.decay_milestones
    gamma = float(cfgs.lr.decay_rate)
    if isinstance(milestones, int):
        def step_lr(step: int) -> float:
            return lr0 * gamma ** ((step // steps_per_epoch) // milestones)
        return step_lr, "epoch"

    ms = [int(m) for m in milestones]

    def multistep(step: int) -> float:
        epoch = step // steps_per_epoch
        return lr0 * gamma ** sum(m <= epoch for m in ms)
    return multistep, "epoch"


def param_groups(model: nn.Module) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """``(weights, biases)`` by the last component of each parameter's name
    (``rpeflow_tpu/train/optim.py:33-40 _group_of``); other parameters are
    frozen."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            weights.append(p)
        elif leaf == "bias":
            biases.append(p)
    return weights, biases


class Optimizer:
    """A torch optimizer whose learning rate follows ``schedule(step)``.

    :meth:`step` sets ``schedule(step_count)`` on every group, updates, and
    counts the step. Zeroing gradients is the caller's (the frozen
    parameters hold gradients too).
    """

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.step_count = 0

    @property
    def lr(self) -> float:
        return float(self.schedule(self.step_count))

    def step(self) -> None:
        lr = self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> Dict:
        return {"step": self.step_count, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.step_count = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])


def optimizer_factory(cfgs, model: nn.Module, steps_per_epoch: int) -> Optimizer:
    """The optimizer of the ``training`` config block over ``model``."""
    schedule, _ = make_lr_schedule(cfgs, steps_per_epoch)
    weights, biases = param_groups(model)
    groups = [{"params": weights, "weight_decay": float(cfgs.weight_decay)},
              {"params": biases, "weight_decay": float(getattr(cfgs, "bias_decay", 0.0))}]
    if cfgs.optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=schedule(0), eps=1e-7)
    elif cfgs.optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=schedule(0),
                              momentum=float(getattr(cfgs.lr, "momentum", 0.0)))
    else:
        raise NotImplementedError(f"Unknown optimizer: {cfgs.optimizer}")
    return Optimizer(opt, schedule)
