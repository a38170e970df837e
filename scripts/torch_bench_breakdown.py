#!/usr/bin/env python3
"""Per-component timing breakdown at the FlyingThings3D eval shape (the
port's counterpart of scripts/bench_breakdown.py).

    python scripts/torch_bench_breakdown.py [--device cuda]

Times, with CUDA events (median of 10 calls, 5 for the forward), the items
of the JAX script at its shapes (batch B = 4, N = 8192 points, decode level
1 of a 576x960 frame = 144x240):

* FPS 8192 -> 4096 on 2B = 8 clouds (``csrc/fps.cu``);
* KNN 4096 self, k = 16;
* KNN from the projected level-1 grid (144 * 240 = 34,560 queries) to 4,096
  points, k = 1;
* the 2-D correlation at level 1 (64 channels, +-4), the kernel
  (``csrc/correlation.cu``) and its plain version;
* PointConv's gather + contraction: ``batch_gather`` of [B, 8192, 67]
  features at [B, 8192, 16] indices, then ``einsum('bskw,bskc->bswc')``
  with [B, 8192, 16, 16] weights;
* the full eval forward (``rpeflow_tpu_torch.flagship``, random weights,
  seed 0) at B = 4, 576x960, 8192 + 8192 points.

float32 with TF32 off; inputs from ``np.random.RandomState(0)`` as in the
JAX script. Smaller shapes for a CPU run: ``--batch``, ``--points``,
``--hw`` and ``--levels``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rpeflow_tpu_torch.flagship import make_batch, model_cfg, n_samples  # noqa: E402
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_  # noqa: E402
from rpeflow_tpu_torch.ops import correlation, fps, knn  # noqa: E402
from rpeflow_tpu_torch.ops.gather import batch_gather  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, time_ms  # noqa: E402

MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--hw", type=int, nargs=2, default=(576, 960))
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    clock = "ms" if dev.type == "cuda" else "ms (host, CPU run)"
    b, n = args.batch, args.points
    h1, w1 = args.hw[0] // 4, args.hw[1] // 4  # decode level 1
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    results = {}

    def item(name, fn, iters=args.iters):
        fn()
        results[name] = time_ms(fn, dev, runs=iters, warmup=1)
        print(f"{name:<44s} {results[name]:10.3f} {clock}", flush=True)

    pc = t(rng.rand(2 * b, n, 3))
    item(f"fps {n}->{n // 2} ({2 * b} clouds)",
         lambda: fps.furthest_point_sampling(pc, n // 2))
    xyz1 = t(rng.rand(b, n // 2, 3))
    item(f"knn {n // 2} self k=16", lambda: knn.k_nearest_neighbor(xyz1, xyz1, 16))
    grid = t(rng.rand(b, h1 * w1, 2) * 200)
    xy = t(rng.rand(b, n // 2, 2) * 200)
    item(f"knn proj grid({h1 * w1})->pts({n // 2}) k=1",
         lambda: knn.k_nearest_neighbor(xy, grid, 1))
    f1, f2 = t(rng.randn(b, h1, w1, 64)), t(rng.randn(b, h1, w1, 64))
    item("correlation2d plain (level 1)", lambda: correlation.correlation2d_plain(f1, f2, 4))
    item("correlation2d kernel (level 1)", lambda: correlation.correlation2d(f1, f2, 4))

    idx = torch.from_numpy(rng.randint(0, n, (b, n, 16)).astype(np.int64)).to(dev)
    feats, w = t(rng.randn(b, n, 67)), t(rng.randn(b, n, 16, 16))

    def pointconv_core():
        g = batch_gather(feats, idx)  # [B, N, k, C]
        return torch.einsum("bskw,bskc->bswc", w, g)

    item(f"pointconv gather+contract ({n},k16)", pointconv_core)

    model = seeded_init_(RPEFlow(model_cfg(), n_samples(n, args.levels)), 0).to(dev).eval()
    batch = make_batch(0, device=dev, b=b, h=args.hw[0], w=args.hw[1], n=n, event_ch=20)

    def forward():
        with torch.inference_mode():
            return model({k: batch[k] for k in MODEL_KEYS})

    item(f"FULL forward (B={b}, {args.hw[0]}x{args.hw[1]}, {n} pts)", forward,
         iters=max(args.iters // 2, 1))
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
