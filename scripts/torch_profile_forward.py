#!/usr/bin/env python3
"""Profile the flagship eval forward (or train step) on the card and
attribute its kernels to the modules that launched them (the port's
counterpart of scripts/profile_forward.py).

    python scripts/torch_profile_forward.py [--train] [--dsec] [--runs 3] [--top 40] \\
        [--out build/torch_profile_forward.tsv] [--device cuda]

The model is ``rpeflow_tpu_torch.flagship``'s (random weights, seed 0) at
batch 4, 576x960, 8192 + 8192 points, float32 with TF32 off. One warm-up
run, then ``--runs`` runs under ``torch.profiler`` (CPU and CUDA
activities), each on its own batch and ending in a device sync, each inside
a ``run<i>`` scope. With ``--dsec`` the model, batch and step are DSEC's
(``model_cfg("l1")``, ``make_dsec_batch`` at batch 3, 480x640, the
fine-tune's Adam). Printed:

* per run, device time by category: each hand-written kernel by name
  (csrc/*.cu), cuDNN conv (its FFT and layout kernels included), GEMM,
  elementwise, reduce, topk/sort, memcpy/memset, other;
* per run, the device-busy time (the union of the kernel, memcpy and memset
  intervals) beside the run's window, and their ratio;
* the top ``--top`` kernels over all runs with the module that launched
  them. Every module pushes a ``module::<name>`` scope (forward pre-hook and
  an always-called forward hook, on a per-thread stack); a kernel's launch
  is found through its correlation id, and its module is the innermost such
  scope above the launch. Activation checkpoints re-run a block's forward
  inside the backward, on the autograd thread, and may stop it early by an
  exception: the per-thread stacks and the always-called hook keep the
  scopes paired, and those scopes are named ``module::<name> [recompute]``.
  A kernel of the backward outside any scope is attributed to its autograd
  node (``backward: <node>``).

On the card, the program's ``rpeflow.*`` spans
(``utils/profile.py : span_table``): per run, each span's count, wall ms,
device-busy ms inside it, idle share and device ms of the work launched
inside it (all of it, and the top module's: the ``decode.level<k>`` rows
split the decoder's ``conv1`` by level); the idle ms outside every span;
and the least lag from a kernel's launch to its start on the device, which
is below 0 if the device's clock is offset from the host's.

The full table (every kernel name and module with its device time per run)
goes to ``--out``. On the CPU (``--device cpu``) there are no device
events: the same tables are made of the host's operators and their self
time, and the busy share is not measured.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from rpeflow_tpu_torch.bench import Runner  # noqa: E402
from rpeflow_tpu_torch.flagship import (DSEC_EVAL, DSEC_TRAIN, dsec_training_cfg,  # noqa: E402
                                         make_batch, make_dsec_batch, model_cfg, n_samples)
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.profile import analyse, capture, category, span_table  # noqa: E402,F401
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device  # noqa: E402

SEED = 0


def capture_runs(dev, train, runs, hw, points, levels, batch, dsec=False):
    """Profile ``runs`` runs of the flagship workload, or DSEC's (after
    one warm-up); returns the profiler's raw (kineto) events."""
    runner = Runner(train, dev, model_cfg("l1" if dsec else "l2"), n_samples(points, levels),
                    SEED, training=dsec_training_cfg() if dsec else None)
    shape = dict(b=batch, h=hw[0], w=hw[1], n=points, event_ch=20)
    make = make_dsec_batch if dsec else make_batch
    batches = [make(SEED + 200 + i, device=dev, targets=train, **shape)
               for i in range(runs + 1)]

    def run(bt):
        out = runner(bt)
        if not train and not torch.isfinite(out["flow_2d"]).all():
            raise AssertionError("the profiled forward is not finite")

    return capture(runner.model, run, batches, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="profile the train step (MI on)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "torch_profile_forward.tsv"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dsec", action="store_true",
                    help="DSEC's model, batch and step (batch 3, 480x640 by default)")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--hw", type=int, nargs=2)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--levels", type=int, default=5)
    args = ap.parse_args(argv)
    default = (DSEC_TRAIN if args.train else DSEC_EVAL) if args.dsec else dict(b=4, h=576, w=960)
    args.batch = args.batch or default["b"]
    args.hw = args.hw or (default["h"], default["w"])
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    on_card = dev.type == "cuda"
    what = ("DSEC " if args.dsec else "") + ("train step" if args.train else "eval forward")
    events = capture_runs(dev, args.train, args.runs, args.hw, args.points, args.levels,
                          args.batch, args.dsec)
    windows, per_run, busy, by_kernel = analyse(events, on_card)
    unit = "device ms" if on_card else "host ms of operators (CPU run)"
    print(f"== {what}: category totals per run ({unit}) ==")
    cats = sorted({c for r in per_run for c in r}, key=lambda c: -sum(r[c] for r in per_run))
    for c in cats:
        print(f"{c:24s} " + "  ".join(f"{r[c]:10.3f}" for r in per_run))
    print(f"{'total':24s} " + "  ".join(f"{sum(r.values()):10.3f}" for r in per_run))
    shares = []
    for i, ((a, b), us) in enumerate(zip(windows, busy)):
        window = (b - a) / 1e3
        if on_card:
            shares.append(us / (b - a))
            print(f"run {i}: device busy {us / 1e3:.3f} ms of a {window:.3f} ms window "
                  f"({shares[-1]:.1%} busy, {1 - shares[-1]:.1%} idle)")
        else:
            print(f"run {i}: window {window:.3f} ms (host); device busy: not measured (CPU run)")
    print(f"\n== top {args.top} kernels ({unit} per run, mean of {len(windows)}) ==")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    for (name, module, _), us in ranked[:args.top]:
        print(f"{us / len(windows) / 1e3:9.3f}  {name[:70]:70s}  {module[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"# {card_line(dev)}\n# {what}, {len(windows)} runs; ms per run; category\t"
                "kernel\tmodule\n")
        for (name, module, cat), us in ranked:
            f.write(f"{us / len(windows) / 1e3:.4f}\t{cat}\t{name}\t{module}\n")
    print(f"\nfull table: {args.out}", flush=True)
    out = {"categories": per_run, "busy_share": shares, "windows_ms":
           [(b - a) / 1e3 for a, b in windows], "kernels": len(by_kernel)}
    if on_card:
        out["spans"] = table = span_table(events)
        print(f"\n== {what}: the program's spans, per run (mean of {table['runs']}; "
              f"top module {table['top_module']}) ==")
        for name, r in table["spans"].items():
            print(f"{name:36s} {r['count']:3g}x wall {r['wall_ms']:9.3f} ms, busy "
                  f"{r['busy_ms']:9.3f} ms, idle {r['idle_pct'] or 0:5.1f}%, launched "
                  f"{r['launched_ms']:9.3f} ms (top module {r['top_ms']:9.3f} ms)")
        print(f"idle {table['idle_ms']:.3f} ms a run, {table['idle_outside_spans_ms']:.3f} ms "
              f"of it outside every span; least launch-to-start lag "
              f"{table['least_lag_us']} us ({table['lags_below_0']} kernels below 0)")
        print(json.dumps({"spans": table}), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
