"""Batched gathers along the point axis (counterpart of rpeflow_tpu/ops/gather.py).

Channels-last: data ``[B, N, C]`` or ``[B, N]``, indices ``[B, I1, ..., Im]``.

Beside :func:`batch_gather` (plain indexing; the main path's gather, as the
JAX package leaves its gather to XLA) are the two hand-written gathers of
``csrc/gather.cu``, the counterparts of the Pallas kernels of
``scripts/bench_gather.py``:

* :func:`gather_rows` ``(table [B, N, C], idx [B, M]) -> [B, M, C]``, for
  ``pallas_rows`` and ``pallas_rowloop`` (one function, one kernel);
* :func:`gather_lanes` ``(table [B, C, N], idx [B, M]) -> [B, C, M]``, for
  ``pallas_lanes``.

Tables are float32 or bfloat16 with any C >= 1, indices int32 or int64, and
the contract is ``0 <= idx < N``, as in the Pallas kernels (the kernel does
not check it; the plain versions raise). For a CUDA tensor the wrappers
launch the kernel (or raise); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from . import _cuda

TABLE_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)


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


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m, :] = table[b, idx[b, m], :]`` by plain indexing."""
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[rows, idx.long()]


def gather_lanes_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, :, m] = table[b, :, idx[b, m]]`` by plain indexing."""
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    return table.transpose(1, 2)[rows, idx.long()].transpose(1, 2).contiguous()


def _check(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"{name}: table {tuple(table.shape)} and idx {tuple(idx.shape)}")
    if table.dtype not in TABLE_DTYPES or idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"{name}: table {table.dtype}, idx {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{name}: operands on {table.device} and {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B, N, C]``, ``idx [B, M]`` -> ``[B, M, C]`` (csrc/gather.cu)."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _check("gather_rows", table, idx)
    b, n, c = table.shape
    m = idx.shape[1]
    out = torch.empty(b, m, c, dtype=table.dtype, device=table.device)
    with _cuda.on_device(table.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, c * table.element_size(),
            int(idx.dtype == torch.int64), stream), "gather_rows")
    _cuda.LAUNCHES["gather_rows"] += 1
    return out


def gather_lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B, C, N]``, ``idx [B, M]`` -> ``[B, C, M]`` (csrc/gather.cu)."""
    if table.device.type == "cpu":
        return gather_lanes_plain(table, idx)
    _check("gather_lanes", table, idx)
    b, c, n = table.shape
    m = idx.shape[1]
    out = torch.empty(b, c, m, dtype=table.dtype, device=table.device)
    with _cuda.on_device(table.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_gather_lanes(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, c, n, m, table.element_size(),
            int(idx.dtype == torch.int64), stream), "gather_lanes")
    _cuda.LAUNCHES["gather_lanes"] += 1
    return out
