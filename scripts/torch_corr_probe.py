"""Where the 2-D correlation's time goes: forward and backward, per call and
in one training step.

    python scripts/torch_corr_probe.py [--plans] [--step]

On the first CUDA device, at each of the five decode levels' shapes of
``chip_smoke.py`` phase 3 (``LEVELS``: f1, f2 ``[4, H, W, C]``, d = 4),
for the forward and for the backward:

* ``ms``: CUDA events around one wrapper call from an idle card, median of
  20, as phase 3 times it (host time included);
* ``dev us``: the device time of the kernels the call launches
  (``torch.profiler``, mean over 5 calls), and the launches per call;
* ``host us``: the wrapper's host time (calls enqueued back to back, no sync).

Then the sums over the five shapes. It measures whichever backward the tree
has: the fused ``correlation2d_bwd`` (one call), or, in a tree from before
it, ``correlation2d_bwd_plain`` (81 shifts of elementwise PyTorch), so that
one session on the card can time a tree and its parent. On a tree with
``correlation_plan``, ``--plans`` also times other tile plans at the five
shapes, each checked against the default plan's result. ``--step`` profiles
one flagship training step (``chip_smoke.py`` phase 8's model and batch, MI
on, after one warm-up step) and gives correlation's forward and backward
device time and launches in that step.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from chip_smoke import LEVELS, time_ms  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda, correlation  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402

D = 4
SHAPES = [(4, h, w, c) for h, w, c, _ in LEVELS]


def backward_call(f1, f2, g):
    """The tree's backward for CUDA tensors, as ``_Correlation2D`` runs it."""
    if hasattr(correlation, "correlation2d_bwd"):
        return lambda: correlation.correlation2d_bwd(f1, f2, g, D)
    return lambda: correlation.correlation2d_bwd_plain(f1, f2, g, D)


def kernels_under(event) -> list:
    """The device kernels that PyTorch's own operators launched inside a
    profiled CPU range (the profiler ties no CPU operator to a kernel
    launched through ``ctypes``: those are found by name, ``corr_kernels``)."""
    out = [k for k in event.kernels if "corr" not in k.name]
    for child in event.cpu_children:
        out += kernels_under(child)
    return out


def corr_kernels(prof) -> dict:
    """{"fwd" | "bwd": (device us, launches)} of the correlation's own
    kernels in a profile."""
    out = {"fwd": [0.0, 0], "bwd": [0.0, 0]}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "corr" in e.key and not e.key.startswith("probe_"):
            t = getattr(e, "self_device_time_total", None)
            r = out["bwd" if "corr_bwd" in e.key else "fwd"]
            r[0] += e.self_cuda_time_total if t is None else t
            r[1] += e.count
    return out


def profiled(fn, n=5):
    """(device us, launches) per call of ``fn``: every kernel in a profile of
    ``n`` calls (and nothing else), from the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            launches += e.count
    return us / n, launches / n


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


def shapes(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    tot: dict = {}
    for shape in SHAPES:
        f1, f2 = (torch.randn(*shape, generator=gen, device=dev) for _ in range(2))
        g = torch.randn(*shape[:3], (2 * D + 1) ** 2, generator=gen, device=dev)
        row = [str(shape)]
        for name, fn in (("forward", lambda: correlation.correlation2d_fwd(f1, f2, D)),
                         ("backward", backward_call(f1, f2, g))):
            ms, (dev_us, launches), hus = time_ms(fn), profiled(fn), host_us(fn)
            for k, v in (("ms", ms), ("dev us", dev_us), ("launches", launches),
                         ("host us", hus)):
                tot[f"{name} {k}"] = tot.get(f"{name} {k}", 0.0) + v
            row.append(f"{name}: {ms:.4f} ms, dev {dev_us:.1f} us in {launches:.0f} launches, "
                       f"host {hus:.1f} us")
        print(" | ".join(row), flush=True)
    print("correlation sums over the five shapes: "
          + "; ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)


def plans(dev) -> None:
    """Other tile plans (tile width and rows) at the five shapes, each
    checked against the default plan's result."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in SHAPES:
        f1, f2 = (torch.randn(*shape, generator=gen, device=dev) for _ in range(2))
        g = torch.randn(*shape[:3], (2 * D + 1) ** 2, generator=gen, device=dev)
        base = {bwd: correlation.correlation_plan(*shape, D, backward=bwd)
                for bwd in (False, True)}
        ref = correlation.launch_fwd(f1, f2, base[False])
        dref = correlation.launch_bwd(f1, f2, g, base[True])
        for bwd in (False, True):
            row = []
            for tw in correlation.TILE_WIDTHS:
                for th in (1, 2, 4):
                    p = correlation.correlation_plan(*shape, D, backward=bwd, th=th, tw=tw)
                    if bwd:
                        call = lambda: correlation.launch_bwd(f1, f2, g, p)  # noqa: E731
                        for a, b in zip(call(), dref):
                            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
                    else:
                        call = lambda: correlation.launch_fwd(f1, f2, p)  # noqa: E731
                        torch.testing.assert_close(call(), ref, atol=1e-5, rtol=0)
                    row.append(f"tw{tw} th{th}: {profiled(call)[0]:.1f}")
            p0 = base[bwd]
            print(f"correlation {'bwd' if bwd else 'fwd'} plans {shape}, device us (default "
                  f"tw{p0.tw} th{p0.th}): " + "  ".join(row), flush=True)


def step(dev) -> None:
    from chip_smoke import N_SAMPLES, SEED, TRAIN, make_batch, model_cfg, training_cfg
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    # eager steps: a replay of the step's CUDA graph runs the kernels but
    # not the wrapped functions, so their ranges would hold no launch
    from rpeflow_tpu_torch.train.state import eager_train_step as train_step

    fn_cls = correlation._Correlation2D
    fwd, bwd = fn_cls.forward, fn_cls.backward

    def fwd_marked(ctx, *args):
        with torch.profiler.record_function("probe_corr_fwd"):
            return fwd(ctx, *args)

    def bwd_marked(ctx, *args):
        with torch.profiler.record_function("probe_corr_bwd"):
            return bwd(ctx, *args)

    fn_cls.forward, fn_cls.backward = staticmethod(fwd_marked), staticmethod(bwd_marked)
    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = make_batch(SEED + 20, device=dev, targets=True, **TRAIN)
    train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
    fn_cls.forward, fn_cls.backward = staticmethod(fwd), staticmethod(bwd)
    events = prof.events()
    total = sum((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.key.startswith("probe_"))
    own = corr_kernels(prof)
    parts = []
    for name in ("fwd", "bwd"):
        ranges = [e for e in events
                  if e.name == f"probe_corr_{name}" and e.device_type == DeviceType.CPU]
        ks = [k for e in ranges for k in kernels_under(e)]
        us, n = own[name][0] + sum(k.duration for k in ks), own[name][1] + len(ks)
        parts.append(f"{name}: {len(ranges)} calls, {n} launches, device {us / 1e3:.4f} ms")
    print(f"correlation in one flagship train step (device {total / 1e3:.2f} ms): "
          + "; ".join(parts), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--plans", action="store_true", help="also time other tile plans")
    parser.add_argument("--step", action="store_true",
                        help="only profile one flagship training step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_corr_probe needs a CUDA device", file=sys.stderr)
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
    if args.plans:
        plans(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
