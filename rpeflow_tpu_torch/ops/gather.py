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

What bounds both on the H100: bytes, the output written once and the table
and indices read once (287.3 MB, 85.8 us at 3.35 TB/s at the gather tool's
B = 4, N = 8192, K = 16, C = 128 f32). ``gather_rows`` copies whole rows
(16-byte words where the row allows). ``gather_lanes`` takes one of two
branches of one launch, chosen by :func:`lanes_plan`:

* staged, where a table row ``table[b, c, :]`` (N * itemsize bytes) fits the
  227 KB a block may hold (N <= 58,112 f32, 116,224 bf16): a block copies
  ``g`` rows into shared memory once (the TMA engine where the table's base
  and row are 16-byte aligned, else plain loads), then writes its range of
  m four at a time from there: the table read from device memory once, the
  indices from the L2 once per channel group (134 MB at the tool's shape,
  ``g = 2``: 256 blocks of 64 KB, three an SM);
* through the L2, for longer rows: a thread per m walks the channels,
  reading each entry as 4 (or 2) bytes of a 32-byte sector.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _cuda

TABLE_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)
#: shared memory a block may take on the H100 (227 KB), and an SM's for its
#: blocks (228 KB, less 1 KB the runtime keeps for each block)
BLOCK_SMEM = 232448
SM_SMEM = 233472
#: the most channels a staged block takes, and its threads (the fastest of
#: g in 1, 2, 4, 7 at 128 to 1024 threads on the H100 by
#: scripts/torch_tools_probe.py --plans; PERF.md)
LANE_GROUP = 2
LANE_THREADS = 512


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


@dataclass(frozen=True)
class LanesPlan:
    """How ``gather_lanes`` launches: ``g`` channels staged a block (0: the
    L2 branch), ``threads`` a block, M cut in ``splits`` ranges."""

    g: int
    threads: int
    splits: int


def lanes_plan(b: int, c: int, n: int, m: int, itemsize: int, num_sms: int = 132) -> LanesPlan:
    """The plan for ``table [b, c, n]`` of ``itemsize``-byte entries at ``m``
    indices: the L2 branch where a row does not fit a block's shared memory;
    else up to ``LANE_GROUP`` rows a block of ``LANE_THREADS``, and M split
    so that the blocks fill the SMs' shared memory when ``b * ceil(c / g)``
    blocks would not (never below four m a thread). An empty call (the
    kernel launches nothing) takes the L2 branch's plan."""
    row = n * itemsize
    if row > BLOCK_SMEM or b * c * n * m == 0:
        return LanesPlan(0, 256, 1)
    g = max(1, min(c, LANE_GROUP, BLOCK_SMEM // row))
    per_sm = max(1, min(SM_SMEM // (g * row + 1024), 2048 // LANE_THREADS))
    groups = b * -(-c // g)
    splits = max(1, min(num_sms * per_sm // groups, -(-m // (4 * LANE_THREADS))))
    return LanesPlan(g, LANE_THREADS, splits)


@functools.lru_cache(maxsize=256)
def _cached_lanes_plan(b: int, c: int, n: int, m: int, itemsize: int,
                       device: torch.device) -> LanesPlan:
    return lanes_plan(b, c, n, m, itemsize, _cuda.sm_count(device))


def launch_lanes(table: torch.Tensor, idx: torch.Tensor, plan: LanesPlan) -> torch.Tensor:
    """One launch of ``csrc/gather.cu``'s lane gather under ``plan``."""
    _check("gather_lanes", table, idx)
    b, c, n = table.shape
    m = idx.shape[1]
    out = torch.empty(b, c, m, dtype=table.dtype, device=table.device)
    with _cuda.on_device(table.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_gather_lanes(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, c, n, m, table.element_size(),
            int(idx.dtype == torch.int64), plan.g, plan.threads, plan.splits, stream),
            "gather_lanes")
    _cuda.LAUNCHES["gather_lanes"] += 1
    return out


def gather_lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B, C, N]``, ``idx [B, M]`` -> ``[B, C, M]`` (csrc/gather.cu)."""
    if table.device.type == "cpu":
        return gather_lanes_plain(table, idx)
    b, c, n = table.shape
    return launch_lanes(table, idx, _cached_lanes_plan(b, c, n, idx.shape[-1],
                                                       table.element_size(), table.device))
