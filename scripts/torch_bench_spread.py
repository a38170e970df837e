#!/usr/bin/env python3
"""The spread of the port's bench within and between processes, on the card.

    python3 scripts/torch_bench_spread.py [--out chiprun_out/spread]

Runs ``python -m rpeflow_tpu_torch.bench`` (both workloads) :data:`RUNS`
times, each in a fresh process, one after the other, while a thread samples
``nvidia-smi``'s SM clock and power draw every 5 s. Each run's stdout and
stderr go to ``<out><i>.out`` / ``.err``; its stdout is read and checked by
``bench.parse_output``. Printed per run and workload: the median, quartiles
and extremes of its iterations (the spread within the process), the median
of its first 3 timed iterations against the median of the rest (whether the
warm-up was long enough), ``value``, ``mfu`` and the traced child's busy
share; the SM clock and power range over the run. Then per workload the
runs' medians and values: their range and its ratio (the spread between
processes). The last line is one JSON object of these numbers. Exits 1 if a
run of the bench fails.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rpeflow_tpu_torch.bench import parse_output  # noqa: E402

#: fresh bench processes, one after the other
RUNS = 3


def sample_card(samples, stop, period=5.0):
    """Append (time, SM MHz, power W) from ``nvidia-smi`` until ``stop``."""
    while not stop.is_set():
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True)
        if out.returncode == 0:
            mhz, watts = out.stdout.splitlines()[0].split(", ")
            samples.append((time.time(), float(mhz), float(watts)))
        stop.wait(period)


def summarise(stdout, samples):
    """Per workload of one bench run's stdout: the spread of its iterations,
    the warm-up check, the value and the traced busy share; the card's clock
    and power range over the run."""
    layers, lines = parse_output(stdout)
    run = {}
    for name, o in lines.items():
        t = np.asarray(o["ms_iters"])
        run[name] = {
            "ms_median": o["ms_median"], "ms_q1": o["ms_q1"], "ms_q3": o["ms_q3"],
            "ms_min": o["ms_min"], "ms_max": o["ms_max"],
            "q3_over_median": o["ms_q3"] / o["ms_median"],
            "first3_median": float(np.median(t[:3])), "rest_median": float(np.median(t[3:])),
            "value": o["value"], "mfu": o["mfu"], "busy_share": layers[name]["busy_share"]}
    if samples:
        mhz, watts = np.asarray([s[1] for s in samples]), np.asarray([s[2] for s in samples])
        run["card"] = {"sm_mhz": [float(mhz.min()), float(mhz.max())],
                       "power_w": [float(watts.min()), float(watts.max())], "samples": len(samples)}
    return run


def between(runs):
    """Per workload, the runs' medians and values, each with its range and
    max / min."""
    out = {}
    for name in runs[0]:
        if name == "card":
            continue
        out[name] = {}
        for key in ("ms_median", "value"):
            v = [r[name][key] for r in runs]
            out[name][key] = {"runs": v, "range": [min(v), max(v)], "ratio": max(v) / min(v)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bench_spread"))
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = []
    for i in range(1, RUNS + 1):
        samples, stop = [], threading.Event()
        sampler = threading.Thread(target=sample_card, args=(samples, stop), daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.bench"],
                                  capture_output=True, text=True, cwd=REPO, timeout=1200)
        finally:
            stop.set()
            sampler.join(timeout=30)
        for ext, text in (("out", proc.stdout), ("err", proc.stderr)):
            with open(f"{args.out}{i}.{ext}", "w") as f:
                f.write(text)
        if proc.returncode != 0:
            print(f"run {i}: the bench failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
            return 1
        runs.append(summarise(proc.stdout, samples))
        print(f"run {i} ({time.perf_counter() - t0:.1f} s): {json.dumps(runs[-1])}", flush=True)
    spread = between(runs)
    for name, s in spread.items():
        print(f"{name}: medians {s['ms_median']['runs']} ms, max / min "
              f"{s['ms_median']['ratio']:.4f}; values {s['value']['runs']}, max / min "
              f"{s['value']['ratio']:.4f}")
    print(json.dumps({"runs": runs, "between": spread}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
