"""The benchmark's cells and their runs.

Everything a cell is made of is data that the harness finds by name from
``BENCHMARK.json``: the configuration (``configs[].file``), the traffic mix
(``benchmark/traffic/<traffic>.json``), the correctness limits
(``benchmark/limits/<cell>.json``) and one reader per per-layer metric
(``benchmark/metrics/<metric>.py``). A cell's end-to-end and per-layer
metrics are those of ``BENCHMARK.json`` that list it under ``workloads``
(or, without that key, every cell that reports the metric it ``moves``).

A run (:func:`run`) makes the weights and a pool of distinct batches on the
device from the seed, builds the program under test from the port's entry
points (:class:`Program`), warms up the cell's shapes, then either times a
closed loop with one caller for ``seconds`` or, traced, profiles a few
iterations; then it frees the program and holds what the timed path
produced to the frozen reference (:mod:`benchmark.check`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check
from .lib import profile
from .lib.traffic import subseed

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "rpeflow_tpu")


def namespace(obj):
    """A JSON object as nested ``SimpleNamespace``s (the port reads its
    configuration by attribute)."""
    if isinstance(obj, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [namespace(v) for v in obj]
    return obj


def log(*args):
    print("benchmark:", *args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries
    per_layer: list
    root: Path

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def train(self) -> bool:
        return self.mode == "train"

    @property
    def with_occ(self) -> bool:
        return bool(self.config["eval"]["with_occ"])

    @property
    def shape(self) -> dict:
        frame = self.config[self.mode]
        return {"b": self.traffic["batch"], "h": frame["h"], "w": frame["w"],
                "n": self.config["points"], "event_ch": self.config["event_channels"]}

    def model_ns(self):
        return namespace(self.config["model"])

    def reader(self, metric: str):
        """The per-layer metric's reader module."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark.metrics." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, int(entry["chips"]), config, traffic, limits, e2e, layer, root)


class Program:
    """The program under test, built from the port's entry points
    (``rpeflow_tpu_torch.model.RPEFlow``, ``train.state.train_step``,
    ``train.optim.optimizer_factory``, ``train.evaluator._metric_sums``).

    Eval: one call is the forward in ``inference_mode`` and the metric sums,
    read to the host as the evaluator reads them; it returns ``(flows,
    sums)``. Train: one call is ``train_step`` with MI on (its noise from a
    generator seeded from the run's seed); it returns the step's summary."""

    def __init__(self, cell: Cell, state_dict: dict, seed: int, dev):
        from rpeflow_tpu_torch.model import RPEFlow

        self.cell = cell
        with torch.device("meta"):
            model = RPEFlow(cell.model_ns(), cell.config["n_samples"])
        self.model = model.to_empty(device=dev)
        self.model.load_state_dict(state_dict)
        if cell.train:
            from rpeflow_tpu_torch.train.optim import optimizer_factory
            from rpeflow_tpu_torch.train.state import train_step

            self.model.train()
            self.opt = optimizer_factory(namespace(cell.config["training"]), self.model,
                                         steps_per_epoch=cell.config["assumed"]["steps_per_epoch"])
            self.gen = torch.Generator(device=dev).manual_seed(subseed(seed, "mi"))
            self._step = train_step
        else:
            from rpeflow_tpu_torch.train.evaluator import _metric_sums

            self.model.eval()
            self._sums = _metric_sums
            self.keys = check.sum_keys(cell.with_occ)

    def __call__(self, batch):
        if self.cell.train:
            return self._step(self.model, self.opt, batch, self.gen)
        with torch.inference_mode():
            flows = self.model({k: batch[k] for k in check.MODEL_KEYS})
            sums = self._sums(flows, batch, self.cell.with_occ)
            return flows, torch.stack([sums[k] for k in self.keys]).tolist()

    def first_gradients(self) -> dict:
        """Each parameter's gradient as the optimizer took it in its first
        step, worked out from Adam's first moment (``(1 - beta1) g`` after
        one step), by name."""
        opt = self.opt.optimizer
        beta1 = {id(p): g["betas"][0] for g in opt.param_groups for p in g["params"]}
        return {n: opt.state[p]["exp_avg"] / (1 - beta1[id(p)])
                for n, p in self.model.named_parameters() if "exp_avg" in opt.state.get(p, {})}


def finite(values) -> bool:
    return all(np.isfinite(v) for v in values)


def first_steps(program: Program, pool, state_dict) -> dict:
    """The train cell's first ``warmup`` steps, on pool batches 0, 1, ...,
    with what :mod:`.check` compares of them."""
    losses, grads = [], None
    for i in range(program.cell.traffic["warmup"]):
        losses.append(program(pool[i])["loss"])
        if i == 0:
            grads = program.first_gradients()
    return check.state_readings(program.model, grads, losses, state_dict)


def window(program, pool, start: int, seconds: float, keep):
    """The closed loop: iterations on the pool's batches from ``start`` on,
    each after the previous one returned, until ``seconds`` have passed
    (the last one started in time finishes). ``keep(i, pool index,
    result)`` sees each result. Returns each iteration's seconds and the
    window's."""
    times, i = [], start
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        result = program(pool[i % len(pool)])
        t1 = time.perf_counter()
        times.append(t1 - t0)
        keep(len(times) - 1, i % len(pool), result)
        i += 1
        if t1 >= deadline:
            return times, t1 - t_start


class Sample:
    """A uniform sample of ``k`` iterations of a window, drawn from the seed
    (reservoir sampling): their pool indices and results."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(subseed(seed, "sample")), []

    def __call__(self, i, pool_index, result):
        if len(self.kept) < self.k:
            self.kept.append((pool_index, result))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.kept[j] = (pool_index, result)


def loaded_forbidden() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def device_info(cell: Cell, dev, peak: int) -> dict:
    on_card = dev.type == "cuda"
    return {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        make_program=Program) -> dict:
    """One run of ``cell``; returns the result line's object (the last key,
    ``checks``, holds each number compared beside its limit)."""
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    traffic = cell.traffic
    sd = check.weights(cell, seed, dev)
    program = make_program(cell, sd, seed, dev)
    pool = [check.batch(cell, seed, i, dev) for i in range(traffic["pool"])]
    warm = traffic["warmup"]
    if cell.train:
        readings = first_steps(program, pool, sd)
    else:
        for i in range(warm):
            program(pool[i])
    del sd
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: set-up {setup_s:.2f} s")

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    sample = Sample(traffic.get("sample", 0), seed)
    failed = 0

    def keep(i, pool_index, res):
        # a failed step's summary is not finite; an eval iteration failed if a
        # metric sum is NaN (a flow's EPE may overflow to inf at random weights)
        nonlocal failed
        failed += not finite(res.values()) if cell.train else any(np.isnan(res[1]))
        sample(i, pool_index, res)
    if trace:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        batches = [pool[(warm + i) % len(pool)] for i in range(traffic["traced"])]
        results = []

        def traced_run(bt):
            results.append(program(bt))

        events = profile.capture(program.model, traced_run, batches, sync)
        for i, res in enumerate(results):
            keep(i, (warm + i) % len(pool), res)
        t0 = time.perf_counter()
        traced = profile.read(events)
        del events
        traced.peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
        log(f"{cell.name}: {traced.iterations} traced iterations, {len(traced.items)} device "
            f"items, read in {time.perf_counter() - t0:.1f} s")
        attempted = len(results)
        del results
    else:
        times, window_s = window(program, pool, warm, seconds, keep)
        attempted = len(times)
        per_item = traffic["batch"] * len(times) / window_s
        values = {"eval_pairs_per_s": per_item, "train_samples_per_s": per_item,
                  "eval_batch_ms_p90": float(np.percentile(np.asarray(times) * 1e3, 90)),
                  "setup_s": setup_s}
        log(f"{cell.name}: {len(times)} iterations in {window_s:.2f} s; ms median "
            f"{np.median(times) * 1e3:.2f}, p90 {values['eval_batch_ms_p90']:.2f}")
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    result["attempted"], result["failed"] = attempted, failed
    found = loaded_forbidden()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")

    kept = sample.kept
    del program, pool, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if cell.train:
        reference, counts = check.reference_train(cell, seed, dev, steps=traffic["warmup"],
                                                  count=trace)
        numbers = check.train_numbers(readings, reference)
    else:
        reference, counts = check.reference_eval(cell, seed, [i for i, _ in kept], dev,
                                                 count=trace, judged=[r[0] for _, r in kept])
        numbers = check.eval_numbers([r for _, r in kept], reference,
                                     check.sum_keys(cell.with_occ))
    correct, checks = check.judge(numbers, cell.limits)
    log(f"{cell.name}: reference in {time.perf_counter() - t0:.1f} s")

    result["device"] = device_info(cell, dev, peak)
    if trace:
        traced.flops_per_iter, traced.calls = counts.flops, counts.calls
        traced.conv_modules, traced.conv_least_s = counts.conv_modules, counts.conv_least_s
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = profile.breakdown(traced)
    result["correct"] = bool(correct and failed == 0)
    result["checks"] = checks
    return result
