"""Data parallelism over ``torch.distributed`` (counterpart of
rpeflow_tpu/parallel/mesh.py).

One process per rank, each with a contiguous slice of the global batch and a
full copy of the parameters. The JAX package gets global-batch semantics
from GSPMD; the port gets them from the collectives here, at the places
where a rank's own arithmetic would differ from one process on the global
batch: batch-norm statistics and the losses' masked-mean counts
(:func:`all_reduce_sum`, differentiable), the gradients
(:func:`all_reduce_grads`), and the summaries (:func:`all_reduce_`).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo takes CUDA
tensors for these three alone, so the same code runs on gloo on the CPU,
on gloo with several ranks on one card, and on NCCL across cards.

With no process group every helper is the identity and issues no call;
with one they issue their collectives even at world size 1.
:data:`COLLECTIVES` counts the collectives issued by call site.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

#: collectives issued per call site; see :func:`reset_collective_counts`.
COLLECTIVES: Dict[str, int] = {}

#: the variables torchrun sets for every rank
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _count(site: str) -> None:
    COLLECTIVES[site] = COLLECTIVES.get(site, 0) + 1


def is_distributed() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes.

    Returns False when the environment names no rank (a plain single-process
    run). Otherwise it makes ``cuda:LOCAL_RANK`` the current device (where
    there is a card), initialises the group (NCCL for a CUDA ``device``,
    gloo for the CPU or when ``backend="gloo"``) and returns True. An
    environment that names ranks but cannot be joined raises: staying on
    one process would train N independent models, each on 1/N of the data.
    """
    env = os.environ
    if "RANK" not in env and "WORLD_SIZE" not in env:
        return False
    if is_distributed():
        return True
    try:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        addr, port = env["MASTER_ADDR"], int(env["MASTER_PORT"])
    except (KeyError, ValueError) as e:
        raise RuntimeError(f"incomplete torchrun environment (needs {', '.join(_ENV)}): "
                           f"{e!r}") from e
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"rank {rank} of {world} could not join the {backend} group at "
                           f"{addr}:{port}") from e
    logging.info("Data parallel: rank %d of %d (%s, local rank %d)", rank, world, backend,
                 local_rank)
    return True


def shard_batch(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous slice of a global batch (the loader's
    ``shard_index``/``num_shards`` slicing)."""
    world, rank = process_count(), process_index()
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows for {world} ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def _flat_groups(tensors: Iterable[torch.Tensor]):
    """The tensors grouped by (device, dtype), in order."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


@torch.no_grad()
def replicate(model: nn.Module) -> nn.Module:
    """Broadcast every parameter and buffer from rank 0 (one broadcast per
    device and dtype), so that every rank starts from rank 0's state."""
    if not is_distributed():
        return model
    for ts in _flat_groups([*model.parameters(), *model.buffers()]):
        flat = torch.cat([t.reshape(-1) for t in ts])
        _count("replicate")
        dist.broadcast(flat, 0)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return model


class _AllReduceSum(torch.autograd.Function):
    """SUM over ranks forward and backward: the gradient of a global sum
    with respect to one rank's term carries every rank's terms."""

    @staticmethod
    def forward(ctx, x, site):
        ctx.site = site
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        _count(f"{ctx.site} (backward)")
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g, None


def all_reduce_sum(x: torch.Tensor, site: str) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable (its backward all-reduces
    the gradient too); ``site`` names the caller in :data:`COLLECTIVES`."""
    if not is_distributed():
        return x
    _count(site)
    return _AllReduceSum.apply(x, site)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, site: str, mean: bool = False) -> torch.Tensor:
    """In place: the sum (or ``mean``) of ``x`` over ranks, no gradient."""
    if not is_distributed():
        return x
    _count(site)
    dist.all_reduce(x)
    if mean:
        x /= process_count()
    return x


@torch.no_grad()
def all_reduce_grads(model: nn.Module) -> None:
    """Replace every gradient by its mean over ranks: one flat buffer, one
    all-reduce. A ``None`` gradient counts as zeros in the buffer and stays
    ``None`` (every rank runs the same graph, so the pattern is the same on
    every rank)."""
    if not is_distributed():
        return
    params = [p for p in model.parameters() if p.requires_grad]
    for ps in _flat_groups(params):
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        all_reduce_(flat, "gradients", mean=True)
        offset = 0
        for p in ps:
            if p.grad is not None:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


def mean_over_ranks(summary: Mapping[str, torch.Tensor], site: str) -> Dict[str, torch.Tensor]:
    """The mean over ranks of every value of a summary of 0-d tensors, in
    one all-reduce."""
    if not is_distributed():
        return dict(summary)
    keys = list(summary)
    vec = all_reduce_(torch.stack([summary[k].detach().float() for k in keys]), site,
                      mean=True)
    return dict(zip(keys, vec.unbind()))


def barrier() -> None:
    if is_distributed():
        _count("barrier")
        dist.barrier()
