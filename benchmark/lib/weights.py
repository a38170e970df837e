"""The model's weights, made on the device from a seed.

Every floating leaf of the state dict (under the upstream names, which the
program and the reference share) takes the scale of
``rpeflow_tpu_torch/model/rpeflow.py : seeded_init_``: conv and linear
weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default
scale; larger weights overflow over five decode levels), norm and attention
weights and temperatures 1 + 0.1 N(0, 1), running variances 0.5 + U(0, 1),
the rest 0.1 N(0, 1). The draws are two calls on one generator on the device
(a uniform and a normal vector as long as all leaves together), sliced leaf
by leaf in the state dict's order, so the same seed gives the same weights
on the same kind of card.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def seeded_state_dict(model: nn.Module, seed: int, device) -> dict:
    """A state dict for ``model`` (whose structure alone is read: build it on
    the ``meta`` device) with every leaf drawn on ``device``."""
    owners = dict(model.named_modules())
    leaves = []
    for name, t in model.state_dict(keep_vars=True).items():
        owner_name, leaf = name.rsplit(".", 1)
        leaves.append((name, t, owners[owner_name], leaf))
    total = sum(t.numel() for _, t, _, _ in leaves if t.is_floating_point())
    g = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(total, generator=g, device=device)
    normal = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, t, owner, leaf in leaves:
        if not t.is_floating_point():
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
            continue
        u = uniform[at:at + t.numel()].view(t.shape)
        z = normal[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if leaf == "running_var":
            val = 0.5 + u
        elif isinstance(owner, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            val = (2 * u - 1) / owner.weight[0].numel() ** 0.5
        elif leaf in ("weight", "temperature"):
            val = 1.0 + 0.1 * z
        else:
            val = 0.1 * z
        out[name] = val
    return out
