#!/usr/bin/env python3
"""Microbenchmark of convex-upsample formulations (the port's counterpart of
scripts/bench_convex.py).

    python scripts/torch_bench_convex.py [--device cuda] [--b 4 --h 144 --w 240 --s 4]

RAFT's convex upsampling of a [B, H, W, 2] flow by S with a
[B, H, W, 9 * S * S] mask (channels last, as the port's
``ops/interp.py : convex_upsample`` takes them), at the JAX script's shape,
B = 4, H = 144, W = 240, S = 4 (decode level 1 of the flagship forward):

  A  the port's ``convex_upsample`` (einsum over the 9 neighbours, then a
     6-D permute);
  B  the JAX script's 32-channel accumulation (9 terms of a repeated mask
     times a tiled flow, channels (sub-row, sub-column, xy)), then the
     depth-to-space as a stride-S ``conv_transpose2d`` with a one-hot kernel;
  C  the same accumulation, then the depth-to-space as a reshape and
     permute.

B and C are first held to A (max |d| < 1e-4, as the JAX script asserts;
a larger one raises), then each is timed: the median of 50 calls between
CUDA events (the host clock on the CPU). Float32 with TF32 off.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from rpeflow_tpu_torch.ops.interp import convex_upsample  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, time_ms  # noqa: E402

TOL = 1e-4
RUNS = 50


def acc32(flow, mask, s):
    """``[B, H, W, s * s * 2]``: channel ``(p * s + q) * 2 + c`` is the convex
    combination of the 9 neighbours' ``s * flow[..., c]`` for sub-pixel
    ``(p, q)``."""
    b, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(b, h, w, 9, s * s), dim=3)
    fp = F.pad(flow * s, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(b, h, w, s * s * 2, dtype=flow.dtype, device=flow.device)
    for n, (di, dj) in enumerate([(i, j) for i in range(3) for j in range(3)]):
        fn = fp[:, di:di + h, dj:dj + w, :]
        acc = acc + m[:, :, :, n, :].repeat_interleave(2, dim=-1) * fn.repeat(1, 1, 1, s * s)
    return acc


def one_hot_kernel(s, device):
    """``conv_transpose2d`` weight ``[s * s * 2, 2, s, s]`` that moves input
    channel ``(p * s + q) * 2 + c`` to output channel c at sub-pixel (p, q)."""
    k = torch.zeros(s * s * 2, 2, s, s, device=device)
    for p in range(s):
        for q in range(s):
            for c in range(2):
                k[(p * s + q) * 2 + c, c, p, q] = 1.0
    return k


def variant_b(flow, mask, s, kernel=None):
    kernel = one_hot_kernel(s, flow.device) if kernel is None else kernel
    acc = acc32(flow, mask, s).permute(0, 3, 1, 2)
    return F.conv_transpose2d(acc, kernel, stride=s).permute(0, 2, 3, 1)


def variant_c(flow, mask, s):
    b, h, w, _ = flow.shape
    acc = acc32(flow, mask, s).reshape(b, h, w, s, s, 2).permute(0, 1, 3, 2, 4, 5)
    return acc.reshape(b, h * s, w * s, 2)


def make_inputs(b, h, w, s, dev, seed=0):
    """The JAX script's seeded ``flow`` and ``mask`` (``randn``)."""
    rng = np.random.RandomState(seed)
    flow = torch.from_numpy(rng.randn(b, h, w, 2).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.randn(b, h, w, 9 * s * s).astype(np.float32)).to(dev)
    return flow, mask


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--h", type=int, default=144)
    ap.add_argument("--w", type=int, default=240)
    ap.add_argument("--s", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    s = args.s
    flow, mask = make_inputs(args.b, args.h, args.w, s, dev)
    kernel = one_hot_kernel(s, dev)
    fns = {"A current": lambda: convex_upsample(flow, mask, s),
           "B conv_transpose d2s": lambda: variant_b(flow, mask, s, kernel),
           "C reshape/permute d2s": lambda: variant_c(flow, mask, s)}
    with torch.inference_mode():
        ref = fns["A current"]()
        errs = {"A current": 0.0}
        for name in list(fns)[1:]:
            errs[name] = float((fns[name]() - ref).abs().max())
            print(f"variant {name[0]}: max err {errs[name]:.2e}", flush=True)
            if not errs[name] < TOL:
                raise AssertionError(f"variant {name}: max |d| {errs[name]} >= {TOL} against A")
        unit = "ms (CUDA events)" if dev.type == "cuda" else "ms (host clock, CPU run)"
        results = {}
        for name, fn in fns.items():
            ms = time_ms(fn, dev, runs=RUNS)
            results[name] = {"ms": ms, "max_abs_err": errs[name]}
            print(f"{name}: {ms:.3f} {unit}", flush=True)
    print(json.dumps({"convex": results, "shape": [args.b, args.h, args.w, s]}), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
