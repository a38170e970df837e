"""Furthest point sampling, plain PyTorch (frozen copy of the plain path of
``rpeflow_tpu_torch/ops/fps.py``): start at index 0, the min-distance field
starts at 1e10, each step picks the argmax of the updated field with the
first index winning ties. One call counts as one call of the port's kernel.
"""

from __future__ import annotations

import torch

from ...lib.flops import counted


def furthest_point_sampling_plain(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``xyz [B, N, 3]`` -> ``[B, n_samples]`` int32, one step at a time."""
    b, n, _ = xyz.shape
    if n_samples > n:
        raise ValueError("n_samples must not exceed the number of points")
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    dists = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    cur = torch.zeros(b, dtype=torch.long, device=xyz.device)
    out = torch.empty(b, n_samples, dtype=torch.long, device=xyz.device)
    for i in range(n_samples):
        out[:, i] = cur
        dx = x - x[rows, cur][:, None]
        dy = y - y[rows, cur][:, None]
        dz = z - z[rows, cur][:, None]
        dists = torch.minimum(dists, dx * dx + dy * dy + dz * dz)
        cur = dists.argmax(-1)
    return out.int()


@counted("fps", lambda xyz, n_samples: (xyz.shape[0], xyz.shape[1], n_samples))
def furthest_point_sampling(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``xyz [B, N, 3]`` float32 -> ``[B, n_samples]`` int32 indices."""
    return furthest_point_sampling_plain(xyz, n_samples)
