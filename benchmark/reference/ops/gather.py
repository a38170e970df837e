"""Batched gathers along the point axis (frozen copy of
``rpeflow_tpu_torch/ops/gather.py : batch_gather, batch_gather_xyz_feat``).

Channels-last: data ``[B, N, C]`` or ``[B, N]``, indices ``[B, I1, ..., Im]``.
"""

from __future__ import annotations

import torch


def batch_gather(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``[B, I1, ..., Im, C]`` (or ``[B, I1, ..., Im]`` for 2-D data)."""
    b = data.shape[0]
    if indices.shape[0] != b:
        raise ValueError("batch size mismatch")
    idx = indices.reshape(b, -1).long()
    rows = torch.arange(b, device=data.device)[:, None]
    out = data[rows, idx]
    return out.reshape(indices.shape + data.shape[2:])


def batch_gather_xyz_feat(xyz: torch.Tensor, feat: torch.Tensor,
                          indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather coordinates (float32) and features at the same indices, as one
    row fetch of ``[xyz | feat]``."""
    merged = batch_gather(torch.cat([xyz.float(), feat], dim=-1), indices)
    return merged[..., :3], merged[..., 3:]
