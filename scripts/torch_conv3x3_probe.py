"""The decoder's 3x3 conv kernel (``csrc/conv3x3.cu``) at the shapes the
model gives it, against ``F.conv2d``.

    python scripts/torch_conv3x3_probe.py [--paths ft3d dsec] [--plans] [--f64]
        [--out build/conv3x3.json]

For each path (``ft3d``: the FT3D eval and training frames, batch 4, 576x960
inside; ``dsec``: DSEC's, batch 3, 512x640 inside) and each distinct shape
of its 55 decoder convs (:func:`chip_smoke.conv3x3_shapes`, the 11 convs at
each of the five decode levels), with seeded inputs:

* ``ms``: CUDA events around one wrapper call (:func:`conv3x3_fwd`), median
  of ``--runs``, and ``library ms`` the same for ``F.conv2d`` on the
  channels-last view in float32, TF32 off (cuDNN's heuristic pick: the
  decoder's call before the kernel); ``dev ms``: CUDA events around
  ``--runs`` calls of each enqueued back to back, over the calls (the
  device's time once the launch queue runs ahead of it; the profiler drops
  records in a process that has profiled much, so it is not used);
* ``bound``: the larger of the FLOPs at 67 TFLOP/s and the bytes at
  3.35 TB/s (``utils/work.py``);
* ``err``: the largest |kernel - F.conv2d| over the largest |F.conv2d|;
  with ``--f64`` also both against ``F.conv2d`` in float64 at level 1 and
  level 5 (the f32 library's own error beside the kernel's);
* whether two calls are bitwise equal.

Then the path's sums over its 55 calls. ``--plans`` times every tile
(``conv3x3_plan``'s ``tile``) at each shape, each checked against the
default plan's result. ``--device cpu --hw 64 64``
runs it on the CPU at a tiny size (host times, the plain version; the
tile plans are not run). The last line of stdout is a JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import conv3x3_shapes  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda  # noqa: E402
from rpeflow_tpu_torch.ops.conv3x3 import (  # noqa: E402
    TILES,
    conv3x3_fwd,
    conv3x3_plain,
    conv3x3_plan,
    launch,
)
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils import timing  # noqa: E402
from rpeflow_tpu_torch.utils.work import bound, kernel_work  # noqa: E402

#: path -> (batch, frame height, width inside the model)
PATHS = {"ft3d": (4, 576, 960), "dsec": (3, 512, 640)}


def operands(shape, dev, seed):
    b, h, w, cin, cout, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=g, device=dev)
    weight = torch.randn(cout, cin, 3, 3, generator=g, device=dev) / (9 * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, generator=g, device=dev)
    return x, weight, bias


def rel_err(out, ref):
    return float((out.double() - ref.double()).abs().max() / ref.double().abs().max())


def queued_ms(fn, runs):
    """ms per call of ``fn`` over ``runs`` calls enqueued back to back
    between two CUDA events, after one call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def probe_shape(shape, dev, seed, runs, f64):
    x, weight, bias = operands(shape, dev, seed)
    d = shape[5]
    kernel = lambda: conv3x3_fwd(x, weight, bias, d)  # noqa: E731
    library = lambda: conv3x3_plain(x, weight, bias, d)  # noqa: E731
    out, ref = kernel(), library()
    rec = {"shape": list(shape), "err": rel_err(out, ref),
           "bitwise_equal": bool(torch.equal(out, kernel())),
           "ms": timing.time_ms(kernel, dev, runs, 1),
           "library_ms": timing.time_ms(library, dev, runs, 1)}
    rec["bound_ms"], rec["bound_by"] = bound(*kernel_work("conv3x3", shape))
    if dev.type == "cuda":
        for key, fn in (("dev_ms", kernel), ("library_dev_ms", library)):
            rec[key] = queued_ms(fn, runs)
    if f64:
        ref64 = conv3x3_plain(x.double(), weight.double(), bias.double(), d)
        rec["err_f64"], rec["library_err_f64"] = rel_err(out, ref64), rel_err(ref, ref64)
    return rec, (x, weight, bias, out)


def probe_plans(shape, dev, ops):
    x, weight, bias, out = ops
    sms = _cuda.sm_count(dev)
    rows = []
    for tile in TILES:
        plan = conv3x3_plan(*shape, num_sms=sms, tile=tile)
        got = launch(x, weight, bias, plan)
        rows.append({"tile": list(tile), "blocks": plan.blocks, "equal_default": bool(
            torch.equal(got, out)), "dev_ms": queued_ms(lambda: launch(x, weight, bias, plan), 10)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=list(PATHS))
    ap.add_argument("--hw", type=int, nargs=2, default=None,
                    help="frame size inside the model (tiny CPU runs)")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = timing.resolve_device(args.device)
    use_f32()
    print(timing.card_line(dev), flush=True)
    report = {"card": timing.card_line(dev), "paths": {}}
    if dev.type == "cuda":
        _cuda.lib()
        lines = [ln for ln in _cuda.build_info["log"].splitlines()
                 if "conv3x3" in ln or "registers" in ln]
        report["build_s"] = _cuda.build_info["seconds"]
        print(f"build {report['build_s']:.1f} s", *lines[:40], sep="\n", flush=True)
    for path in args.paths:
        b, h, w = PATHS[path]
        if args.hw:
            h, w = args.hw
        shapes = conv3x3_shapes(b, h, w)
        recs = {}
        for k, shape in enumerate(dict.fromkeys(shapes)):
            level = ((h >> 2) // shape[1]).bit_length()  # 1 the finest
            f64 = args.f64 and level in (1, 5)
            rec, ops = probe_shape(shape, dev, 1000 + k, args.runs, f64)
            rec["level"] = level
            if args.plans and dev.type == "cuda":
                rec["plans"] = probe_plans(shape, dev, ops)
            del ops
            recs[shape] = rec
            extra = "".join(f"  {key} {rec[key]:.3e}" for key in ("err_f64", "library_err_f64")
                            if key in rec)
            dev_ms = (f"  dev {rec['dev_ms']:.4f} / {rec['library_dev_ms']:.4f} ms"
                      if "dev_ms" in rec else "")
            print(f"  {path} L{level} {str(shape):34s} kernel {rec['ms']:9.4f} ms  library "
                  f"{rec['library_ms']:9.4f} ms{dev_ms}  bound {rec['bound_ms']:8.4f} ms "
                  f"({rec['bound_by']})  err {rec['err']:.3e}{extra}  "
                  f"bitwise {rec['bitwise_equal']}", flush=True)
            for row in rec.get("plans", []):
                print(f"      tile {row['tile']} {row['blocks']:6d} blocks {row['dev_ms']:9.4f} ms "
                      f"equal {row['equal_default']}", flush=True)
        sums = {key: sum(recs[s][key] for s in shapes)
                for key in ("ms", "library_ms", "bound_ms", "dev_ms", "library_dev_ms")
                if key in next(iter(recs.values()))}
        sums["calls"] = len(shapes)
        sums["max_err"] = max(r["err"] for r in recs.values())
        sums["bitwise_equal"] = all(r["bitwise_equal"] for r in recs.values())
        print(f"  {path}: {sums}", flush=True)
        report["paths"][path] = {"sums": sums, "shapes": list(recs.values())}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"conv3x3": {p: r["sums"] for p, r in report["paths"].items()}}))
    return report


if __name__ == "__main__":
    main()
