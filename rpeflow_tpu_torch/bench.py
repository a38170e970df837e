"""The port's benchmark (counterpart of ``bench.py``): the FlyingThings3D
eval forward and the pretrain step timed on the card.

    python -m rpeflow_tpu_torch.bench [--workload ft3d_eval|ft3d_train|all] [--seed 0]

Workloads (:data:`WORKLOADS`), both at full width and depth, float32 with
TF32 off (``train/precision.py : use_f32``), random weights from
``seeded_init_(seed)`` and batches from ``flagship.make_batch``:

* ``ft3d_eval``: the model block of conf/test/things.yaml in
  ``inference_mode``, batch 4, 576x960, a 20-channel event voxel, 8192 +
  8192 points, 5 decode levels, IDS on;
* ``ft3d_train``: conf/train/pretrain.yaml's model and Adam,
  ``train/state.py : train_step`` with MI on, batch 4, 540x960 frames,
  8192 + 8192 points.

For each workload: a batch for every timed iteration (each from its own
seed, so no two are bit-equal) and one for the warm-up are made on the card
first; one iteration under :class:`~rpeflow_tpu_torch.utils.flops.FlopCount`
gives the FLOPs of an iteration; ``warmup`` untimed iterations (cuDNN's
algorithm choice, the kernels' build, the allocator) come next; then
``iters`` iterations, each timed on the host clock between two
``torch.cuda.synchronize()`` calls, the kernel launches of the first one
counted; ``value`` is the samples of all of them over the sum of their
times, beside the iterations' median and quartiles. Outside the timed
window: every element of the last ``flow_2d`` and ``flow_3d`` finite
(eval); every step's summary finite and a parameter moved (train).
Nothing is retried and no reading is dropped.

A train step runs as a CUDA graph from its second call on
(``train/graph.py``): the counted step runs eagerly (its first sight), the
first warm-up step captures, every later step replays; the bench prints
the step counter (``train/graph.py : STEPS``) of each train workload on
stderr.

Then, per workload, a fresh child process (``--traced``) runs 3 iterations
under ``torch.profiler`` (after one warm-up) and reports the device ms per
iteration by category, the device-busy share of each iteration's window and
the launches per iteration: tracing stays out of the timed run.

Printed on stdout: one ``{"layers": ...}`` line from the traced children,
then one metric line per workload (:func:`metric_line`). Progress goes to
stderr. The bench exits 1, printing no metric line, if a workload's output
is not finite, a step moved no parameter, its ``mfu`` is not in (0, 1.05],
or a model kernel's launches per iteration differ from the path's
(:data:`EVAL_LAUNCHES`, :data:`TRAIN_LAUNCHES`: a kernel that launched less
means a plain path ran), or if a traced child fails; 2 when there is no
card. It runs only on the card: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .flagship import FLAGSHIP, TRAIN, make_batch, model_cfg, n_samples, training_cfg
from .train import graph
from .utils import timing

MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
# The reference publishes no throughput numbers; this RTX3090 figure is an
# estimate for the reference implementation on its eval hardware (mean
# forward time ~0.5 s/batch of 4 -> ~8 frame-pairs/sec), used only to
# normalize ``vs_baseline`` (bench.py, BASELINE.md "Derivation": roughly
# +/-2x uncertain, and ``vs_baseline`` inherits that).
RTX3090_FRAME_PAIRS_PER_SEC_EST = 8.0
#: largest believable share of the f32 peak (timing.PEAK_F32); above it the
#: timing or the count is broken
MFU_LIMIT = 1.05
#: iterations of the traced run in its child process
TRACED_RUNS = 3
#: the model kernels' launches in one iteration of each path (phases 5 and 8
#: of chip_smoke.py): one FPS, a cost volume at each of the 5 decode levels,
#: the MDTA front halves, GDFNs and depthwise convs of the fusers' blocks,
#: the 11 decoder 3x3 convs at each level; in a step their backwards too (the
#: correlation's fused one, the depthwise conv's inside the MDTA and GDFN
#: backwards; the decoder convs' backward is cuDNN's)
EVAL_LAUNCHES = {"fps": 1, "correlation2d": 5, "correlation2d_bwd": 0, "mdta_qkv": 30,
                 "gdfn": 15, "dwconv": 15, "conv3x3": 55}
TRAIN_LAUNCHES = {"fps": 1, "correlation2d": 5, "correlation2d_bwd": 5, "mdta_qkv": 80,
                  "gdfn": 40, "dwconv": 340, "conv3x3": 55}


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    train: bool
    metric: str
    unit: str
    shape: dict          # flagship.make_batch's b, h, w, n, event_ch
    levels: int          # decode levels
    iters: int           # timed iterations
    warmup: int          # untimed iterations before them
    expected: dict       # model kernel launches in one iteration


WORKLOADS = {
    "ft3d_eval": Workload("ft3d_eval", False, "inference_throughput_ft3d_eval",
                          "frame_pairs_per_sec_per_chip", FLAGSHIP, 5, 30, 6, EVAL_LAUNCHES),
    "ft3d_train": Workload("ft3d_train", True, "train_throughput_ft3d", "samples/s", TRAIN, 5,
                           20, 3, TRAIN_LAUNCHES),
}


class Runner:
    """One iteration of a workload: the eval forward in ``inference_mode``
    (returns the outputs) or one train step with MI on (returns its
    summary). The model (``cfg``, ``samples`` points a decode level) is
    ``seeded_init_(seed)``'s; a step's optimizer is ``training``'s Adam
    (pretrain.yaml's by default) and its MI noise comes from a generator
    seeded with ``seed``."""

    def __init__(self, train, dev, cfg, samples, seed, training=None):
        from .model import RPEFlow, seeded_init_

        self.train = train
        self.model = seeded_init_(RPEFlow(cfg, samples), seed).to(dev)
        if train:
            from .train.optim import optimizer_factory

            self.model.train()
            self.opt = optimizer_factory(training or training_cfg(), self.model,
                                         steps_per_epoch=100)
            self.gen = torch.Generator(device=dev).manual_seed(seed)
        else:
            self.model.eval()

    def __call__(self, batch):
        if self.train:
            from .train.state import train_step

            return train_step(self.model, self.opt, batch, self.gen)
        with torch.inference_mode():
            return self.model({k: batch[k] for k in MODEL_KEYS})


def make_batches(wl, dev, seed, count):
    """``count`` batches of the workload's shape on ``dev``, the i-th from
    seed ``seed + 100 + i``."""
    return [make_batch(seed + 100 + i, device=dev, targets=wl.train, **wl.shape)
            for i in range(count)]


def count_flops(run, batch) -> float:
    """FLOPs of one iteration (:mod:`.utils.flops`)."""
    from .utils.flops import FlopCount

    with FlopCount() as count:
        run(batch)
    return count.total


def output_faults(wl, outputs, moved) -> list:
    """What is wrong with the outputs: eval, any element of the last
    ``flow_2d`` or ``flow_3d`` not finite; train, any value of any step's
    summary not finite, or no parameter moved (``moved`` False)."""
    faults = []
    if wl.train:
        bad = [i for i, sm in enumerate(outputs) if not all(np.isfinite(v) for v in sm.values())]
        if bad:
            faults.append(f"summaries of steps {bad} not finite")
        if not moved:
            faults.append("no parameter moved")
    else:
        faults += [f"{key} not finite" for key in ("flow_2d", "flow_3d")
                   if not bool(torch.isfinite(outputs[-1][key]).all())]
    return faults


def measure(wl, dev, seed, cfg=None):
    """The untraced run of a workload. Returns ``(times_ms, flop_per_iter,
    peak_gib, batches_gib, launches, faults)``: each timed iteration's ms,
    the FLOPs of one iteration, the peak of allocated device memory over the
    timed iterations (pre-made batches included) and those batches' GiB
    (both None off the card), the model kernels' launches in the first
    timed iteration and :func:`output_faults`."""
    from .ops import _cuda

    runner = Runner(wl.train, dev, model_cfg() if cfg is None else cfg,
                    n_samples(wl.shape["n"], wl.levels), seed)
    batches = make_batches(wl, dev, seed, wl.iters + 1)
    warm, batches = batches[0], batches[1:]
    batches_gib = sum(t.numel() * t.element_size() for bt in batches for t in bt.values()) / 2**30
    flop = count_flops(runner, warm)
    for _ in range(wl.warmup):
        runner(warm)
    before = [p.detach().clone() for p in runner.model.parameters()] if wl.train else None
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    times, outputs, launches = [], [], None
    for i, bt in enumerate(batches):
        timing.sync(dev)
        if i == 0:
            _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = runner(bt)
        timing.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = {k: _cuda.LAUNCHES[k] for k in wl.expected}
        outputs.append(out if wl.train else None)
    outputs[-1] = out
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    moved = before is not None and any(
        not torch.equal(a, p.detach()) for a, p in zip(before, runner.model.parameters()))
    faults = output_faults(wl, outputs, moved)
    return times, flop, peak, batches_gib if on_card else None, launches, faults


def device_info(dev) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    name, power = timing.card_line(dev).splitlines()[0].rsplit(", ", 1)
    return {"name": name, "power_limit": power}


def metric_line(wl, times_ms, flop, peak_gib, batches_gib, launches, device) -> dict:
    """The workload's metric line: ``value``, the samples of all timed
    iterations over the whole timed window (``ms_window``, the sum of the
    iterations' ms, so a stall inside the window lowers it); the median,
    quartiles and extremes of the iterations' ms; ``flop_per_iter`` and
    ``mfu``, its share of the f32 peak at the median (``timing.PEAK_F32``)."""
    t = np.asarray(times_ms, dtype=np.float64)
    median, window = float(np.median(t)), float(t.sum())
    q1, q3 = (float(v) for v in np.percentile(t, [25, 75]))
    value = wl.shape["b"] * len(t) / (window * 1e-3)
    line = {"workload": wl.name, "metric": wl.metric, "value": value, "unit": wl.unit}
    if not wl.train:
        line["vs_baseline"] = value / RTX3090_FRAME_PAIRS_PER_SEC_EST
    line.update(
        ms_window=window, ms_median=median, ms_q1=q1, ms_q3=q3, ms_min=float(t.min()),
        ms_max=float(t.max()), iters=len(t), warmup=wl.warmup, ms_iters=[float(v) for v in t],
        peak_gib=peak_gib, batches_gib=batches_gib, flop_per_iter=flop,
        mfu=flop / (median * 1e-3 * timing.PEAK_F32), precision="float32, TF32 off",
        launches=launches, device=device)
    return line


def refusals(line, launches, expected, faults=()) -> list:
    """Why a reading cannot stand: the output faults, a ``value`` not
    finite and positive, an ``mfu`` outside (0, MFU_LIMIT], launches of a
    model kernel other than the path's."""
    out = list(faults)
    if not (np.isfinite(line["value"]) and line["value"] > 0):
        out.append(f"value {line['value']}")
    if not 0 < line["mfu"] <= MFU_LIMIT:
        out.append(f"mfu {line['mfu']} outside (0, {MFU_LIMIT}]")
    differ = {k: (launches.get(k, 0), n) for k, n in expected.items() if launches.get(k, 0) != n}
    if differ:
        out.append(f"launches in one iteration (got, expected): {differ}")
    return out


def report(results) -> int:
    """Print each accepted ``(line, reasons)``'s metric line on stdout and
    each refused one's reasons on stderr; 1 if any was refused, else 0."""
    refused = [(line, reasons) for line, reasons in results if reasons]
    for line, reasons in refused:
        print(f"bench: {line['workload']} refused: {'; '.join(reasons)}", file=sys.stderr)
    if refused:
        return 1
    for line, _ in results:
        print(json.dumps(line), flush=True)
    return 0


def parse_output(stdout):
    """The ``layers`` object and the metric lines by workload of one bench
    run's stdout; raises ``ValueError`` unless there is one ``layers`` line
    and a metric line for every workload, each with its workload's metric,
    a finite ``value`` and an ``mfu`` in (0, MFU_LIMIT]."""
    objs = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    found = [o["layers"] for o in objs if "layers" in o]
    lines = {o["workload"]: o for o in objs if "metric" in o}
    if len(found) != 1 or sorted(lines) != sorted(WORKLOADS):
        raise ValueError(f"bench: {len(found)} layers lines, metric lines of {sorted(lines)}")
    for name, line in lines.items():
        if line["metric"] != WORKLOADS[name].metric or not np.isfinite(line["value"]) \
                or not 0 < line["mfu"] <= MFU_LIMIT:
            raise ValueError(f"bench {name}: {line}")
    return found[0], lines


def layers(wl, dev, seed, cfg=None, runs=TRACED_RUNS) -> dict:
    """The traced run: ``runs`` iterations (after one warm-up) under
    ``torch.profiler``. Per iteration: the ms by category (device time on
    the card, the host operators' self time on the CPU), each window's ms
    and device-busy share (not measured on the CPU), and the model kernels'
    launches (counted over the warm-up and the traced runs)."""
    from .ops import _cuda
    from .utils.profile import analyse, capture

    runner = Runner(wl.train, dev, model_cfg() if cfg is None else cfg,
                    n_samples(wl.shape["n"], wl.levels), seed)
    batches = make_batches(wl, dev, seed + 1000, runs + 1)
    _cuda.reset_launch_counts()
    events = capture(runner.model, runner, batches, dev)
    launches = {k: _cuda.LAUNCHES[k] / (runs + 1) for k in wl.expected}
    on_card = dev.type == "cuda"
    windows, per_run, busy, _ = analyse(events, on_card)
    cats = sorted({c for r in per_run for c in r}, key=lambda c: -sum(r[c] for r in per_run))
    unit = "device_ms" if on_card else "host_ms"
    return {"runs": len(per_run),
            unit: {c: sum(r[c] for r in per_run) / len(per_run) for c in cats},
            f"{unit}_total": sum(sum(r.values()) for r in per_run) / len(per_run),
            "window_ms": [(b - a) / 1e3 for a, b in windows],
            "busy_share": [us / (b - a) for us, (a, b) in zip(busy, windows)] if on_card
            else "not measured",
            "launches_per_iter": launches}


def traced_child(name, seed, timeout=900) -> dict:
    """:func:`layers` of workload ``name`` in a fresh process on the card
    (its CUDA context its own); raises if the child fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.bench", "--traced", name,
                           "--seed", str(seed)], capture_output=True, text=True, cwd=root,
                          timeout=timeout)
    print(proc.stdout + proc.stderr, end="", file=sys.stderr, flush=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the traced run of {name} failed (exit {proc.returncode})")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=[*WORKLOADS, "all"], default="all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traced", choices=list(WORKLOADS),
                    help="run the traced run of this workload in this process (the bench "
                         "starts one such child per workload)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rpeflow_tpu_torch.bench: torch.cuda.is_available() is False; the bench runs "
              "only on a CUDA card and has no CPU fallback", file=sys.stderr)
        return 2
    from .train.precision import use_f32

    use_f32()
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.traced:
        print(json.dumps(layers(WORKLOADS[args.traced], dev, args.seed)), flush=True)
        return 0
    device = device_info(dev)
    names = list(WORKLOADS) if args.workload == "all" else [args.workload]
    results = []
    for name in names:
        wl = WORKLOADS[name]
        t0 = time.perf_counter()
        graph.reset_step_counts()
        times, flop, peak, batches_gib, launches, faults = measure(wl, dev, args.seed)
        if wl.train:
            print(f"bench: {name}: train steps {graph.STEPS}", file=sys.stderr, flush=True)
        gc.collect()  # the cached blocks back for the next workload and the children
        torch.cuda.empty_cache()
        line = metric_line(wl, times, flop, peak, batches_gib, launches, device)
        results.append((line, refusals(line, launches, wl.expected, faults)))
        print(f"bench: {name}: median {line['ms_median']:.2f} ms of {wl.iters} "
              f"({time.perf_counter() - t0:.1f} s with set-up)", file=sys.stderr, flush=True)
    try:
        traced = {name: traced_child(name, args.seed) for name in names}
    except (RuntimeError, subprocess.TimeoutExpired, ValueError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"layers": traced, "device": device}), flush=True)
    return report(results)


if __name__ == "__main__":
    sys.exit(main())
