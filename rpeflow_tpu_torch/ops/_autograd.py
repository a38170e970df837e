"""Backward by recomputation, for the fused MDTA and GDFN functions: their
plain composition is recomputed under autograd, with the K5 depthwise conv
(:func:`rpeflow_tpu_torch.ops.dwconv.dwconv`) inside, and differentiated, as
the JAX package's custom VJPs differentiate their plain references."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def vjp_by_recompute(fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                     needs_grad: Sequence[bool], g: torch.Tensor):
    """Gradients of ``fn(*inputs)`` against ``g``, one per input (None where
    ``needs_grad`` is False), by recomputing ``fn`` under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, g) if wanted else ())
    return tuple(next(grads) if t.requires_grad else None for t in leaves)
