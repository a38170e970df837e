"""Train and eval steps (counterpart of rpeflow_tpu/train/state.py).

One training step is forward with the loss, backward, the optimizer's
update and, through the forward in training mode, the batch-norm
statistics' update. The summary holds floats: ``loss``, ``loss_2d``,
``loss_3d``, ``mi_loss``, the flow metrics and ``grad_norm`` (the global
norm of every parameter's gradient, the frozen ``temperature`` included, as
``optax.global_norm`` counts it).

Under data parallelism (:mod:`..parallel.mesh`) each rank runs its slice of
the global batch; the gradients are averaged over the ranks before the norm
and the update, and the summaries are the means over the ranks, so that
every rank takes the step of one process on the global batch.

On CUDA parameters and outside a process group, the step runs as a
replay of a CUDA graph of itself from the second time its signature (the
batch's shapes, ``compute_mi``, the model's mode) comes (:mod:`.graph`);
every call is still one update on the given batch, and computes what an
eager step computes.

A step opens the profiler spans ``rpeflow.train_step`` and, inside it, on
an eager step ``.backward``, ``.update`` (the gradients' reduction and norm,
the optimizer), on a replay ``.replay``, and on both ``.read`` (the
summary's one read, where the host waits for the step); the forward of an
eager step opens its own (:mod:`..model.rpeflow`).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..parallel.mesh import all_reduce_grads, mean_over_ranks
from ..utils.profile import span
from . import graph
from .optim import Optimizer


def grad_norm(model: nn.Module) -> torch.Tensor:
    grads = [p.grad.float() for p in model.parameters() if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum((g * g).sum() for g in grads))


def _step(model: nn.Module, compute_mi: bool, batch: Dict[str, torch.Tensor],
          generator: Optional[torch.Generator], update: Callable[[], None]):
    """The step's device work, what a graph captures: the forward with the
    loss, the backward, the gradients' reduction and norm and ``update()``.
    Returns the summary's keys and its values stacked in one tensor."""
    model.zero_grad(set_to_none=True)
    _, aux = model(batch, compute_mi=compute_mi, compute_loss=True, generator=generator)
    with span("rpeflow.train_step.backward"):
        aux["loss"].backward()
    with span("rpeflow.train_step.update"):
        all_reduce_grads(model)
        summary = mean_over_ranks(aux["scalar_summary"], "train summary")
        summary["grad_norm"] = grad_norm(model)
        update()
    return list(summary), torch.stack(list(summary.values()))


def _read(keys, values: torch.Tensor) -> Dict[str, float]:
    with span("rpeflow.train_step.read"):
        return dict(zip(keys, values.tolist()))


def train_step(model: nn.Module, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], compute_mi: bool = True) -> Dict[str, float]:
    """One optimizer step on ``batch`` (tensors on the model's device); the
    model must be in training mode. ``generator`` feeds the MI noise."""
    with span("rpeflow.train_step"):
        body = functools.partial(_step, model, compute_mi)
        return _read(*graph.run(model, optimizer, batch, generator, compute_mi, body))


def eager_train_step(model: nn.Module, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator],
                     compute_mi: bool = True) -> Dict[str, float]:
    """:func:`train_step` run eagerly whatever its inputs, on the current
    stream: what a replay is held to."""
    with span("rpeflow.train_step"):
        return _read(*_step(model, compute_mi, batch, generator, optimizer.step))


@torch.no_grad()
def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """Forward with the loss and metrics, no MI, in eval mode; returns
    ``(outputs, summary of floats)``, the summary's values means over the
    ranks."""
    was_training = model.training
    model.eval()
    try:
        outputs, aux = model(batch, compute_mi=False, compute_loss=True)
    finally:
        model.train(was_training)
    summary = mean_over_ranks(aux["scalar_summary"], "eval summary")
    return outputs, {k: float(v) for k, v in summary.items()}
