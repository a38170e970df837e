"""Where the depthwise-conv kernel's time goes, and its time under other plans.

    python scripts/torch_dwconv_probe.py

On the first CUDA device, at each of the 38 shapes of ``chip_smoke.py``
phase 3 (``dwconv_shapes``: one training step's calls), for each wrapper
call of a forward + backward (the forward, and the backward's calls):

* ``ms``: CUDA events around one wrapper call from an idle card, median of
  20, as phase 3 times it (host time included);
* ``dev us``: the device time of each kernel the call launches, by kernel
  (``torch.profiler``, mean over 5 calls): the forward, the fused backward,
  the parent tree's taps gradient, the partial sum, and any other kernel (the
  parent tree's flip copy of the taps);
* ``host us``: the wrapper's host time (calls enqueued back to back, no sync).

Then the sums over the 38 shapes and over the ten largest (``LARGE``). It
measures whichever backward the tree has: the fused ``dwconv_bwd`` (one
call), or, in a tree from before it, the rotated-taps forward and
``dwconv_taps_grad`` (two calls), so that one session on the card can
time a tree and its parent. Then what plain copies reach at the largest shape
(``yardstick``). On a tree with ``dwconv_plan``, ``--plans`` also times
other plans (vector width, rows per thread, backward blocks) at the ten
largest shapes, each checked against the default plan's
result. ``--step``
profiles one flagship training step (``chip_smoke.py`` phase 8's model and
batch, MI on, after one warm-up step) and gives the depthwise conv's device
time by kernel and its launches in that step.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from chip_smoke import dwconv_shapes, time_ms  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda, dwconv  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402

SHAPES = dwconv_shapes()
#: the ten shapes with the most data (b * h * w * C): most of the bound
LARGE = sorted(SHAPES, key=lambda s: -s[0] * s[1] * s[2] * s[3])[:10]


def kernel_class(name: str) -> str:
    for key in ("dw_fwd", "dw_bwd", "dw_taps", "sum_partials_kernel"):
        if key in name:
            return key
    return "other"


def calls(x, g, taps):
    """The wrapper calls of one forward + backward on this tree."""
    if hasattr(dwconv, "dwconv_bwd"):
        return {"forward": lambda: dwconv.dwconv_fwd(x, taps),
                "backward": lambda: dwconv.dwconv_bwd(x, g, taps)}
    kh = taps.shape[0]
    return {"forward": lambda: dwconv.dwconv_fwd(x, taps),
            "input grad": lambda: dwconv.dwconv_fwd(g, taps.flip(0, 1).contiguous()),
            "taps grad": lambda: dwconv.dwconv_taps_grad(x, g, kh)}


def by_kernel(prof) -> dict:
    """Device microseconds in a profile, by kernel class."""
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[kernel_class(e.key)] += e.self_cuda_time_total if t is None else t
    return dict(out)


def device_us(fn, n=5) -> dict:
    """Device microseconds per call of ``fn``, by kernel class."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {k: v / n for k, v in by_kernel(prof).items()}


def host_us(fn, n=20) -> float:
    """Host microseconds per call of ``fn``, enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def inputs(g, b, h, w, c, kh):
    dev = g.device
    x = torch.randn(b, h, w, c, generator=g, device=dev)
    gout = torch.randn(b, h, w, c, generator=g, device=dev)
    return x, gout, torch.randn(kh, 3, c, generator=g, device=dev) / 3


def shapes(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    tot = defaultdict(float)
    large = defaultdict(float)
    for shape in SHAPES:
        x, gout, taps = inputs(gen, *shape)
        parts = calls(x, gout, taps)
        whole = lambda: [fn() for fn in parts.values()]  # noqa: E731
        ms = time_ms(whole)
        row = [f"{shape} pass {ms:.4f} ms"]
        sums = {"pass ms": ms}
        for name, fn in parts.items():
            dev_us = device_us(fn)
            part_ms, part_host = time_ms(fn), host_us(fn)
            sums[f"{name} ms"] = part_ms
            sums[f"{name} host us"] = part_host
            for k, v in dev_us.items():
                sums[f"{name} dev us {k}"] = v
            row.append(f"{name}: {part_ms:.4f} ms, host {part_host:.1f} us, dev us "
                       + " ".join(f"{k} {v:.1f}" for k, v in sorted(dev_us.items())))
        for k, v in sums.items():
            tot[k] += v
            if shape in LARGE:
                large[k] += v
        print(" | ".join(row), flush=True)
    for title, d in (("all 38 shapes", tot), ("ten largest", large)):
        dev_total = sum(v for k, v in d.items() if " dev us " in k)
        print(f"dwconv sums over {title}: device {dev_total / 1e3:.4f} ms; "
              + "; ".join(f"{k} {v:.4f}" for k, v in d.items()), flush=True)


def plans(dev) -> None:
    """Other plans at the ten largest shapes: vector width, rows per thread,
    and the backward's blocks."""
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = _cuda.sm_count(dev)
    for b, h, w, c, kh in LARGE:
        x, gout, taps = inputs(gen, b, h, w, c, kh)
        fwd = dwconv.dwconv_plan(b, h, w, c, kh, sms)
        bwd = dwconv.dwconv_plan(b, h, w, c, kh, sms, backward=True)
        ref = dwconv.launch_fwd(x, taps, fwd)
        dref = dwconv.launch_bwd(x, gout, taps, bwd)
        row = []
        for v in (v for v in (1, 2, 4) if c % v == 0):
            for rh in dict.fromkeys((fwd.rh, 8, 16, 32)):
                p = dwconv.dwconv_plan(b, h, w, c, kh, sms, v=v, rh=rh)
                torch.testing.assert_close(dwconv.launch_fwd(x, taps, p), ref, atol=1e-5, rtol=0)
                row.append(f"v{v} tx{p.tx} rh{p.rh}: "
                           f"{time_ms(lambda: dwconv.launch_fwd(x, taps, p)):.4f}")
        print(f"dwconv fwd plans {(b, h, w, c, kh)} (plan v{fwd.v} tx{fwd.tx} rh{fwd.rh}): "
              + "  ".join(row), flush=True)
        row = []
        for v in (v for v in (1, 2) if c % v == 0):
            base = dwconv.dwconv_plan(b, h, w, c, kh, sms, backward=True, v=v)
            for rh, nb in dict.fromkeys(((base.rh, base.nb), (base.rh, 2 * base.nb),
                                         (16, base.nb), (32, base.nb))):
                p = dwconv.dwconv_plan(b, h, w, c, kh, sms, backward=True, v=v, rh=rh, nb=nb)
                dx, dtaps = dwconv.launch_bwd(x, gout, taps, p)
                torch.testing.assert_close(dx, dref[0], atol=1e-5, rtol=0)
                rel = float((dtaps - dref[1]).abs().max() / dref[1].abs().max())
                assert rel <= 1e-4, (p, rel)
                row.append(f"v{v} tx{p.tx} rh{p.rh} nb{p.nb}: "
                           f"{time_ms(lambda: dwconv.launch_bwd(x, gout, taps, p)):.4f}")
        print(f"dwconv bwd plans {(b, h, w, c, kh)} (plan v{bwd.v} tx{bwd.tx} rh{bwd.rh} "
              f"nb{bwd.nb}): " + "  ".join(row), flush=True)


def yardstick(dev) -> None:
    """What plain copies reach at the largest shape: one read and one write
    (``copy_``), two reads and one write (``add``), in TB/s."""
    b, h, w, c, _ = LARGE[0]
    x, y, out = (torch.randn(b, h, w, c, device=dev) for _ in range(3))
    nbytes = 4 * x.numel()
    copy = time_ms(lambda: out.copy_(x))
    add = time_ms(lambda: torch.add(x, y, out=out))
    print(f"yardstick {(b, h, w, c)}: copy_ {copy:.4f} ms ({2 * nbytes / copy / 1e9:.3f} TB/s), "
          f"add {add:.4f} ms ({3 * nbytes / add / 1e9:.3f} TB/s)", flush=True)


def step(dev) -> None:
    from chip_smoke import N_SAMPLES, SEED, TRAIN, make_batch, model_cfg, training_cfg
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = make_batch(SEED + 20, device=dev, targets=True, **TRAIN)
    train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
    launches = _cuda.LAUNCHES["dwconv"]
    out = by_kernel(prof)
    total = sum(out.values())
    dw = {k: v for k, v in out.items() if k != "other"}
    print(f"dwconv in one flagship train step: {launches} launches, device "
          f"{sum(dw.values()) / 1e3:.4f} ms of the step's {total / 1e3:.2f} ms; by kernel (us): "
          + " ".join(f"{k} {v:.1f}" for k, v in sorted(dw.items())), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--plans", action="store_true", help="also time other plans")
    parser.add_argument("--step", action="store_true",
                        help="only profile one flagship training step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_dwconv_probe needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    use_f32()
    _cuda.lib()
    if args.step:
        step(dev)
        return 0
    shapes(dev)
    yardstick(dev)
    if args.plans:
        plans(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
