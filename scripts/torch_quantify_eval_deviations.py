#!/usr/bin/env python3
"""How much the fixed-``n_points`` eval resampling moves the metrics (the
port's counterpart of scripts/quantify_eval_deviations.py, its resample
half).

    python scripts/torch_quantify_eval_deviations.py [--h 288 --w 480 --n 8192 --b 2]

The reference evaluates variable-size point clouds; the eval pipeline
resamples every item to a static 8192 points. On the flagship model of
``rpeflow_tpu_torch/flagship.py`` with ``seeded_init_(0)`` weights (no
trained checkpoint is at hand; the spread across draws is the quantity of
interest), one scene of 2n points per batch item is drawn (the JAX script's
``_synth_batch`` with ``RandomState(1)``), and three fixed-n subsamples of it
with ``RandomState(100 + seed)``, as the JAX script draws them. Each
subsample goes through the whole eval forward; printed are each draw's
metric means (EPE2d, 1px, Fl, EPE3d, 5cm, 10cm), each metric's mean and
max - min spread over the draws, each forward's ms (CUDA events; the host
clock on the CPU) after one warm-up forward, and the launches of the hand
kernels in the three forwards (``_cuda.LAUNCHES``; none on the CPU).

The JAX script's other half, exact against approximate KNN, is not ported:
the approximate backend (``approx_min_k``) exists only on the TPU.
Float32 with TF32 off.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rpeflow_tpu_torch.flagship import model_cfg, n_samples  # noqa: E402
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda  # noqa: E402
from rpeflow_tpu_torch.train.evaluator import _metric_sums  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, sync  # noqa: E402

MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
SEEDS = 3


def metric_means(outputs, batch):
    """The JAX script's six metric means of one batch (``_metric_sums``
    without occlusion), from tensors or numpy arrays."""
    sums = {k: float(v) for k, v in _metric_sums(
        {k: torch.as_tensor(v) for k, v in outputs.items()},
        {k: torch.as_tensor(v) for k, v in batch.items()}, False).items()}
    return {
        "EPE2d": sums["2d/EPE2d"] / sums["2d/counts"],
        "1px": sums["2d/1px"] / sums["2d/counts"],
        "Fl": sums["2d/Fl"] / sums["2d/counts"],
        "EPE3d": sums["3d/EPE3d"] / sums["3d/counts"],
        "5cm": sums["3d/5cm"] / sums["3d/counts"],
        "10cm": sums["3d/10cm"] / sums["3d/counts"],
    }


def synth_batch(rng, b, h, w, n, bins):
    """The JAX package's ``__graft_entry__._synth_batch`` with targets
    (numpy, the same draws in the same order)."""
    pc = rng.rand(b, n, 6).astype(np.float32)
    pc[..., 2] = pc[..., 2] * 20 + 2.0
    pc[..., 5] = pc[..., 5] * 20 + 2.0
    return {
        "images": (rng.rand(b, h, w, 6) * 255).astype(np.float32),
        "pcs": pc,
        "event_voxel": rng.rand(b, h, w, 2 * bins).astype(np.float32),
        "intrinsics": np.tile(
            np.array([[1050.0, (w - 1) / 2, (h - 1) / 2]], np.float32), (b, 1)),
        "flow_2d": rng.randn(b, h, w, 2).astype(np.float32),
        "flow_3d": (rng.randn(b, n, 3) * 0.1).astype(np.float32),
    }


def resamples(b, h, w, n):
    """The three fixed-n subsamples of one 2n-point scene (numpy batches)."""
    big = synth_batch(np.random.RandomState(1), b, h, w, 2 * n, bins=10)
    subs = []
    for seed in range(SEEDS):
        rs = np.random.RandomState(100 + seed)
        idx = np.stack([rs.choice(2 * n, n, replace=False) for _ in range(b)])
        sub = dict(big)
        sub["pcs"] = np.take_along_axis(big["pcs"], idx[..., None], axis=1)
        sub["flow_3d"] = np.take_along_axis(big["flow_3d"], idx[..., None], axis=1)
        subs.append(sub)
    return subs


def fmt(m):
    return "  ".join(f"{k}={v:.6f}" for k, v in m.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=288)
    ap.add_argument("--w", type=int, default=480)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--levels", type=int, default=5, help="decode levels (5: the flagship)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    print("[knn] exact vs approx KNN: not run; the approximate backend (approx_min_k) "
          "exists only on the TPU (ROADMAP A.9)", flush=True)
    model = seeded_init_(RPEFlow(model_cfg(), n_samples(args.n, args.levels)), seed=0).to(dev)
    model.eval()
    subs = resamples(args.b, args.h, args.w, args.n)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in sub.items()} for sub in subs]

    def forward(batch):
        with torch.inference_mode():
            return model({k: batch[k] for k in MODEL_KEYS})

    forward(batches[0])  # warm-up
    sync(dev)
    _cuda.reset_launch_counts()
    per_seed, times = [], []
    for seed, batch in enumerate(batches):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = forward(batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = forward(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        m = metric_means(out, batch)
        per_seed.append(m)
        print(f"[resample seed {seed}] {fmt(m)}  forward {times[-1]:.2f} ms", flush=True)
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    spread = {}
    for k in per_seed[0]:
        vals = np.array([m[k] for m in per_seed])
        spread[k] = {"mean": float(vals.mean()), "spread": float(vals.max() - vals.min())}
        print(f"[resample] {k}: mean={spread[k]['mean']:.6f} "
              f"spread(max-min)={spread[k]['spread']:.6g}")
    print(f"[resample] b={args.b} {args.h}x{args.w} n={args.n}: forward ms "
          + ", ".join(f"{t:.2f}" for t in times)
          + f"; hand-kernel launches in the {SEEDS} forwards: {launches or 'none (CPU run)'}",
          flush=True)
    result = {"per_seed": per_seed, "spread": spread, "forward_ms": times, "launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
