"""Exact k-nearest-neighbour search (frozen copy of rpeflow_tpu_torch/ops/knn.py).

Only the exact backend is ported: off the TPU the JAX package's ``auto``
backend is exact too, and ``approx_min_k`` exists only on the TPU. The
pairwise distance uses the same formula as the JAX ``squared_distance``,
``-2 a.b + |a|^2 + |b|^2`` added in that order, so ties round alike.

The query axis is chunked: unlike XLA, which fuses the k = 1 argmin into the
distance computation, PyTorch materialises the ``[B, Qc, N]`` distance
block, and the decode's pixel-grid search is ``[2B, H*W, N]`` =
8 x 34560 x 4096 (about 4.5 GB of float32) at the finest level.
"""

from __future__ import annotations

import torch

# Largest distance block materialised at once, in float32 elements (512 MB).
CHUNK_BUDGET_ELEMS = 128 * 1024 * 1024


def squared_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., M, D]``, ``[..., N, D]`` -> ``[..., M, N]`` squared distances."""
    a = a.float()
    b = b.float()
    d = -2.0 * torch.matmul(a, b.transpose(-1, -2))
    d = d + (a * a).sum(-1)[..., :, None]
    return d + (b * b).sum(-1)[..., None, :]


def _pick_chunk(q: int, n: int, b: int) -> int:
    chunk = q
    while chunk > 128 and b * chunk * n > CHUNK_BUDGET_ELEMS:
        chunk //= 2
    return max(chunk, 1)


def k_nearest_neighbor(input_xyz: torch.Tensor, query_xyz: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Indices ``[B, Q, k]`` (int64) of each query's k nearest input points,
    by ascending distance. ``input_xyz [B, N, D]``, ``query_xyz [B, Q, D]``.

    ``k == 1`` takes the first minimum, as ``jnp.argmin`` does; for ``k > 1``
    the order among exactly tied distances is ``torch.topk``'s.
    """
    b, q, _ = query_xyz.shape
    n = input_xyz.shape[1]
    if k > n:
        raise ValueError(f"k={k} exceeds the candidate point count n={n}")
    chunk = _pick_chunk(q, n, b)
    out = []
    for q0 in range(0, q, chunk):
        dist = squared_distance(query_xyz[:, q0:q0 + chunk], input_xyz)
        if k == 1:
            out.append(dist.argmin(-1, keepdim=True))
        else:
            out.append(torch.topk(dist, k, dim=-1, largest=False, sorted=True).indices)
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)
