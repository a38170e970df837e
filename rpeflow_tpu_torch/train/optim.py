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

On CUDA parameters Adam is built ``capturable``, its learning rate a 0-d
float32 tensor on the device that :meth:`Optimizer.set_lr` writes before
each update, so that the update can be captured in a CUDA graph and
replayed (``train/graph.py``); on the CPU it is the plain Adam.
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

    :meth:`step` sets ``schedule(step_count)`` on every group
    (:meth:`set_lr`), updates, and counts the step. Zeroing gradients is the
    caller's (the frozen parameters hold gradients too). :attr:`graphs`
    holds the train steps captured with this optimizer (``train/graph.py``);
    :meth:`load_state_dict` drops them, as it replaces the state tensors
    they update.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.step_count = 0
        self.graphs = None

    @property
    def lr(self) -> float:
        return float(self.schedule(self.step_count))

    @property
    def capturable(self) -> bool:
        return all(g.get("capturable", False) for g in self.optimizer.param_groups)

    def set_lr(self) -> None:
        """Write ``schedule(step_count)`` into every group: into its device
        tensor where the learning rate is one (a capturable Adam)."""
        lr = self.lr
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def step(self) -> None:
        self.set_lr()
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> Dict:
        return {"step": self.step_count, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """Load a state saved by either kind of Adam: each group keeps this
        optimizer's own ``lr`` and ``capturable``, and a plain Adam takes its
        step counts on the host."""
        saved = state["optimizer"]
        own = self.optimizer.param_groups
        groups = [dict(g, **{k: mine[k] for k in ("lr", "capturable") if k in mine})
                  for g, mine in zip(saved["param_groups"], own)]
        steps_on_host = not self.capturable
        per_param = {i: (dict(s, step=s["step"].cpu())
                         if steps_on_host and torch.is_tensor(s.get("step")) else s)
                     for i, s in saved["state"].items()}
        self.optimizer.load_state_dict({"state": per_param, "param_groups": groups})
        self.step_count = int(state["step"])
        self.graphs = None


def optimizer_factory(cfgs, model: nn.Module, steps_per_epoch: int) -> Optimizer:
    """The optimizer of the ``training`` config block over ``model``."""
    schedule, _ = make_lr_schedule(cfgs, steps_per_epoch)
    weights, biases = param_groups(model)
    groups = [{"params": weights, "weight_decay": float(cfgs.weight_decay)},
              {"params": biases, "weight_decay": float(getattr(cfgs, "bias_decay", 0.0))}]
    params = list(model.parameters())
    if cfgs.optimizer == "adam" and params and all(p.is_cuda for p in params):
        lr = torch.tensor(schedule(0), dtype=torch.float32, device=params[0].device)
        opt = torch.optim.Adam(groups, lr=lr, eps=1e-7, capturable=True)
        # its eager steps (the first of each step shape) are meant: no warning
        opt._warned_capturable_if_run_uncaptured = True
    elif cfgs.optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=schedule(0), eps=1e-7)
    elif cfgs.optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=schedule(0),
                              momentum=float(getattr(cfgs.lr, "momentum", 0.0)))
    else:
        raise NotImplementedError(f"Unknown optimizer: {cfgs.optimizer}")
    return Optimizer(opt, schedule)
