"""Furthest point sampling (counterpart of rpeflow_tpu/ops/fps.py and the
Pallas kernel rpeflow_tpu/ops/pallas/fps.py).

:func:`furthest_point_sampling` launches the CUDA kernel ``csrc/fps.cu`` for
a CUDA tensor and runs :func:`furthest_point_sampling_plain` for a CPU
tensor. Both follow ``furthest_point_sampling_scan``: start at index 0, the
min-distance field starts at 1e10, each step picks the argmax of the updated
field with the first index winning ties.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..utils.flops import counted

# the kernel holds up to 32 points in each of its 512 threads' registers
MAX_POINTS = 32 * 512


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
    if xyz.device.type == "cpu":
        return furthest_point_sampling_plain(xyz, n_samples)
    b, n, d = xyz.shape
    if d != 3 or not 0 < n_samples <= n:
        raise ValueError(f"fps: bad shape {tuple(xyz.shape)} for {n_samples} samples")
    if n > MAX_POINTS:
        raise ValueError(f"fps: {n} points exceed the kernel's {MAX_POINTS}")
    _cuda.require_cuda("fps", xyz)
    out = torch.empty(b, n_samples, dtype=torch.int32, device=xyz.device)
    with _cuda.on_device(xyz.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_fps(xyz.data_ptr(), b, n, n_samples,
                                            out.data_ptr(), stream), "fps")
    _cuda.LAUNCHES["fps"] += 1
    return out
