"""One data-parallel train step over n CPU processes (counterpart of
``__graft_entry__.py : dryrun_multichip``).

    python -m rpeflow_tpu_torch.parallel.dryrun [n]

:func:`spawn_ranks` starts n processes with torchrun's environment, ranks
0..n-1 of one group on this host, all on one device (``LOCAL_RANK`` 0);
:func:`dryrun_multichip` runs through it the whole step -- forward, losses,
MI, backward, the gradient all-reduce and Adam -- of a 2-decode-level model
at 64x64 over gloo on the CPU, and checks the step count, a finite loss and
bitwise-equal parameters on every rank.
"""

from __future__ import annotations

import os
import socket
import sys
from types import SimpleNamespace as NS

import numpy as np
import torch

from .mesh import (
    COLLECTIVES,
    maybe_initialize_distributed,
    process_count,
    process_index,
    replicate,
    shard_batch,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    fn(*args)


def spawn_ranks(fn, world: int, *args) -> None:
    """``fn(*args)`` in ``world`` spawned processes, each with torchrun's
    environment for one rank (``fn`` joins the group through
    :func:`maybe_initialize_distributed`); raises if a rank fails."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world, free_port(), fn, args), nprocs=world, join=True)


def model_cfg():
    """The JAX dryrun's model block (``__graft_entry__._model_cfg``) at a
    KNN k of 8 and one event bin per polarity."""
    losses = NS(level_weights=[8, 4, 2, 1, 0.5], order="l2")
    return NS(name="RPEFlow", freeze_bn=False, ids=NS(enabled=True, sensor_size_divisor=32),
              pwc2d=NS(event_bins=1, event_polarity=True, max_displacement=4,
                       norm=NS(feature_pyramid="batch_norm", flow_estimator=None,
                               context_network=None)),
              pwc3d=NS(k=8, norm=NS(feature_pyramid="batch_norm", correlation=None,
                                    flow_estimator=None)),
              loss2d=losses, loss3d=losses)


def synthetic_batch(seed: int, b: int, h: int = 64, w: int = 64, n: int = 64,
                    event_ch: int = 2):
    """A global batch with targets, from a seed; its points project inside
    the image, and a tenth of its flow targets are masked out."""
    rng = np.random.RandomState(seed)
    f, cx, cy = 0.9 * w, (w - 1) / 2, (h - 1) / 2
    z = rng.uniform(3.0, 20.0, (b, n))
    u, v = rng.uniform(0, w - 1, (b, n)), rng.uniform(0, h - 1, (b, n))
    pc1 = np.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1)
    flow3d = 0.1 * rng.randn(b, n, 3)
    batch = {
        "images": (rng.rand(b, h, w, 6) * 255).astype(np.uint8),
        "pcs": np.concatenate([pc1, pc1 + flow3d], -1),
        "event_voxel": rng.rand(b, h, w, event_ch),
        "intrinsics": np.tile([f, cx, cy], (b, 1)),
        "flow_2d": np.concatenate([2 * rng.randn(b, h, w, 2), rng.rand(b, h, w, 1) > 0.1], -1),
        "flow_3d": np.concatenate([flow3d, rng.rand(b, n, 1) > 0.1], -1),
    }
    return {k: torch.from_numpy(np.asarray(v, np.uint8 if k == "images" else np.float32))
            for k, v in batch.items()}


def _dryrun_rank() -> None:
    from ..model import RPEFlow, seeded_init_
    from ..train.optim import optimizer_factory
    from ..train.state import train_step

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // process_count()))
    maybe_initialize_distributed("cpu")
    world = process_count()
    model = seeded_init_(RPEFlow(model_cfg(), (32, 16)), seed=0).train()
    replicate(model)
    training = NS(max_epochs=2, optimizer="adam", weight_decay=1e-6, bias_decay=0.0,
                  lr=NS(scheduler="MultiStepLR", init_value=4e-4, decay_rate=0.5,
                        decay_milestones=[1]))
    opt = optimizer_factory(training, model, steps_per_epoch=10)
    batch = shard_batch(synthetic_batch(7, b=world))
    summary = train_step(model, opt, batch, torch.Generator().manual_seed(7))
    if opt.step_count != 1 or not np.isfinite(summary["loss"]):
        raise AssertionError(f"rank {process_index()}: step {opt.step_count}, {summary}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    if not torch.equal(flat, ref):
        raise AssertionError(f"rank {process_index()}: parameters differ from rank 0's")
    if process_index() == 0:
        print(f"dryrun_multichip({world}): ok, loss={summary['loss']:.4f}, collectives "
              f"{dict(sorted(COLLECTIVES.items()))}", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel train step over ``n_devices`` gloo CPU processes."""
    spawn_ranks(_dryrun_rank, n_devices)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
