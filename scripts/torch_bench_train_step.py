#!/usr/bin/env python3
"""Time the full training step (forward, loss, MI, backward, Adam) on the
card (the port's counterpart of scripts/bench_train_step.py).

    python scripts/torch_bench_train_step.py [--batch 4] [--iters 10] [--amp] [--device cuda]

The model is conf/train/pretrain.yaml's (``rpeflow_tpu_torch.flagship``:
``model_cfg``, ``training_cfg``) with random weights (``seeded_init_``,
seed 0), at 576x960 with 8192 + 8192 points and a 20-channel event voxel,
MI on, float32 with TF32 off (``--amp``: bfloat16 in the two 2-D feature
pyramids). One warm-up step, then ``--iters`` timed steps, each on a fresh
batch whose bits differ from every other's (``flagship.make_batch`` with
its own seed); the clock stops after a read of an updated parameter, which
waits for the last step's update. Prints ms/step, samples/s, the last loss,
whether every summary was finite, the peak device memory and the card's
name and power limit. (``--segmented`` of the JAX script works around
XLA:TPU and is not ported.)
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rpeflow_tpu_torch.flagship import make_batch, model_cfg, n_samples, training_cfg  # noqa: E402
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_  # noqa: E402
from rpeflow_tpu_torch.train.optim import optimizer_factory  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.train.state import train_step  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, sync  # noqa: E402

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--amp", action="store_true",
                    help="bfloat16 in the two 2-D feature pyramids (the trainer's amp)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", type=int, nargs=2, default=(576, 960))
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--levels", type=int, default=5, help="decode levels (5 in the paper)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smi = card_line(dev)
    print(smi, flush=True)
    use_f32()

    model = seeded_init_(RPEFlow(model_cfg(), n_samples(args.points, args.levels), amp=args.amp),
                         SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = dict(b=args.batch, h=args.hw[0], w=args.hw[1], n=args.points, event_ch=20)
    batches = [make_batch(SEED + 100 + i, device=dev, targets=True, **shape)
               for i in range(args.iters + 1)]
    last = [p for p in model.parameters() if p.requires_grad][-1]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    train_step(model, opt, batches[0], gen)
    float(last.detach().reshape(-1)[0])
    print(f"first step (warm-up): {time.perf_counter() - t0:.1f} s", flush=True)
    summaries = []
    sync(dev)
    t0 = time.perf_counter()
    for bt in batches[1:]:
        summaries.append(train_step(model, opt, bt, gen))
    float(last.detach().reshape(-1)[0])  # waits for the last update
    dt = (time.perf_counter() - t0) / args.iters
    finite = all(math.isfinite(v) for sm in summaries for v in sm.values())
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured (CPU run)")
    clock = "" if dev.type == "cuda" else " (host times of a CPU run)"
    print(f"train step{clock}: {dt * 1000:.1f} ms/step ({args.batch / dt:.2f} samples/s), "
          f"loss={summaries[-1]['loss']:.2f}, finite={finite}, peak device memory {peak}, "
          f"batch {args.batch}, {args.hw[0]}x{args.hw[1]}, {args.points} points, MI on, "
          f"amp={args.amp}; {smi}", flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
