"""Train and eval steps (counterpart of rpeflow_tpu/train/state.py).

One training step is forward with the loss, backward, the optimizer's
update and, through the forward in training mode, the batch-norm
statistics' update. The summary holds floats: ``loss``, ``loss_2d``,
``loss_3d``, ``mi_loss``, the flow metrics and ``grad_norm`` (the global
norm of every parameter's gradient, the frozen ``temperature`` included, as
``optax.global_norm`` counts it).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .optim import Optimizer


def grad_norm(model: nn.Module) -> torch.Tensor:
    grads = [p.grad.float() for p in model.parameters() if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum((g * g).sum() for g in grads))


def train_step(model: nn.Module, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], compute_mi: bool = True) -> Dict[str, float]:
    """One optimizer step on ``batch`` (tensors on the model's device); the
    model must be in training mode. ``generator`` feeds the MI noise."""
    model.zero_grad(set_to_none=True)
    _, aux = model(batch, compute_mi=compute_mi, compute_loss=True, generator=generator)
    aux["loss"].backward()
    summary = dict(aux["scalar_summary"])
    summary["grad_norm"] = grad_norm(model)
    optimizer.step()
    return {k: float(v) for k, v in summary.items()}


@torch.no_grad()
def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """Forward with the loss and metrics, no MI, in eval mode; returns
    ``(outputs, summary of floats)``."""
    was_training = model.training
    model.eval()
    try:
        outputs, aux = model(batch, compute_mi=False, compute_loss=True)
    finally:
        model.train(was_training)
    return outputs, {k: float(v) for k, v in aux["scalar_summary"].items()}
