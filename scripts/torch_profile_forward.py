#!/usr/bin/env python3
"""Profile the flagship eval forward (or train step) on the card and
attribute its kernels to the modules that launched them (the port's
counterpart of scripts/profile_forward.py).

    python scripts/torch_profile_forward.py [--train] [--runs 3] [--top 40] \\
        [--out build/torch_profile_forward.tsv] [--device cuda]

The model is ``rpeflow_tpu_torch.flagship``'s (random weights, seed 0) at
batch 4, 576x960, 8192 + 8192 points, float32 with TF32 off. One warm-up
run, then ``--runs`` runs under ``torch.profiler`` (CPU and CUDA
activities), each on its own batch and ending in a device sync, each inside
a ``run<i>`` scope. Printed:

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

The full table (every kernel name and module with its device time per run)
goes to ``--out``. On the CPU (``--device cpu``) there are no device
events: the same tables are made of the host's operators and their self
time, and the busy share is not measured.
"""

import argparse
import bisect
import collections
import itertools
import os
import re
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from rpeflow_tpu_torch.flagship import make_batch, model_cfg, n_samples, training_cfg  # noqa: E402
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, sync  # noqa: E402

SEED = 0
RUN_RE = re.compile(r"run\d+")
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
SCOPES = ("module::", AUTOGRAD_NODE)
RUNTIME_RE = re.compile(r"cu(da)?[A-Z]")
MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
#: the hand-written kernels (csrc/*.cu): __global__ function -> its wrapper's launch key
HAND = {fn: key for kernels in _cuda.SOURCES.values() for fn, key in kernels.items()}
_HAND_RE = re.compile(r"(?:^|::|\s)(" + "|".join(sorted(HAND, key=len, reverse=True)) + r")\b")
#: (category, pattern on the lower-cased kernel or operator name), first match wins
CATEGORIES = [
    ("memcpy/memset", r"memcpy|memset|aten::copy_|aten::fill_|aten::zero_"),
    ("cuDNN conv", r"cudnn|conv|fft|winograd|implicit|dgrad|wgrad|fprop|cgemm|nchw|nhwc"),
    ("GEMM", r"gemm|gemv|cutlass|cublas|matmul|\baten::(mm|bmm|addmm|baddbmm|linear)\b"),
    ("topk/sort", r"topk|sort|radix|bitonic|cub::"),
    ("reduce", r"reduce|norm|softmax|\baten::(sum|mean|max|min|amax|argmax|argmin|prod)\b"),
    ("elementwise", r"elementwise|vectorized|unrolled|^aten::"),  # ^: a host operator
]


def category(name: str, op: str = "") -> str:
    """The category of a kernel (or host operator) ``name`` launched by the
    operator ``op``: a hand-written kernel by its name, else the first
    pattern that matches the kernel's or its operator's name (the FFT
    convolution's complex GEMMs and transforms belong to the conv that
    launched them)."""
    m = _HAND_RE.search(name)
    if m:
        return f"kernel {HAND[m.group(1)]}"
    text = (name if op in ("", name) else f"{name} | {op}").lower()
    for cat, pattern in CATEGORIES:
        if re.search(pattern, text):
            return cat
    return "other"


class ModuleScopes:
    """``module::<name>`` profiler scopes around every submodule's forward."""

    def __init__(self, model):
        self.local = threading.local()
        names = {m: n or "model" for n, m in model.named_modules()}
        self.handles = []
        for module, name in names.items():
            self.handles.append(module.register_forward_pre_hook(self._enter(name)))
            self.handles.append(module.register_forward_hook(self._exit(name), always_call=True))

    def _stack(self):
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def _enter(self, name):
        def hook(module, args):
            recompute = torch._C._current_graph_task_id() != -1
            scope = torch.autograd.profiler.record_function(
                f"module::{name}" + (" [recompute]" if recompute else ""))
            scope.__enter__()
            self._stack().append((name, scope))
        return hook

    def _exit(self, name):
        def hook(module, args, output):
            stack = self._stack()
            while stack:  # pops scopes a stopped recompute left open, then this one
                top, scope = stack.pop()
                scope.__exit__(None, None, None)
                if top == name:
                    break
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


class Scopes:
    """The ``module::`` and autograd-node scopes of one host thread, for
    finding the innermost one around a time (a launch)."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, -end, name), properly nested
        self.starts = [sp[0] for sp in self.spans]
        self.parent, stack = [], []
        for i, (start, neg_end, _) in enumerate(self.spans):
            while stack and -self.spans[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t):
        """Names of the scopes around ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        names = []
        while i >= 0:
            start, neg_end, name = self.spans[i]
            if start <= t <= -neg_end:
                names.append(name)
            i = self.parent[i]
        return names


def attribution(scopes, thread, t) -> str:
    """The innermost module scope around a launch, else its autograd node."""
    names = scopes[thread].around(t) if thread in scopes else []
    for name in names:
        if name.startswith("module::"):
            return name[len("module::"):]
    for name in names:
        if name.startswith(AUTOGRAD_NODE):
            return "backward: " + name[len(AUTOGRAD_NODE):]
    return "(no module)"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def capture(dev, train, runs, hw, points, levels, batch):
    """Profile ``runs`` runs; returns the profiler's raw (kineto) events."""
    model = seeded_init_(RPEFlow(model_cfg(), n_samples(points, levels)), SEED).to(dev)
    shape = dict(b=batch, h=hw[0], w=hw[1], n=points, event_ch=20)
    batches = [make_batch(SEED + 200 + i, device=dev, targets=train, **shape)
               for i in range(runs + 1)]
    if train:
        from rpeflow_tpu_torch.train.optim import optimizer_factory
        from rpeflow_tpu_torch.train.state import train_step

        model.train()
        opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def run(bt):
            train_step(model, opt, bt, gen)
    else:
        model.eval()

        def run(bt):
            with torch.inference_mode():
                out = model({k: bt[k] for k in MODEL_KEYS})
            if not torch.isfinite(out["flow_2d"]).all():
                raise AssertionError("the profiled forward is not finite")

    run(batches[0])  # warm-up
    sync(dev)
    scopes = ModuleScopes(model)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            for i, bt in enumerate(batches[1:]):
                with torch.autograd.profiler.record_function(f"run{i}"):
                    run(bt)
                    sync(dev)
    finally:
        scopes.remove()
    return prof.profiler.kineto_results.events()


def analyse(events, on_card):
    """Per run: category totals (ms), busy us and window us; over all runs:
    (name, module, category) -> total us. On the card the work items are
    the device events (kernels, memcpy, memset), each found its launch (the
    runtime call) through its correlation id; on the CPU they are the host
    operators with their self time."""
    t0 = time.perf_counter()
    windows, spans, items, host_ops = [], collections.defaultdict(list), [], []
    ops, runtime = {}, {}  # operators by id; runtime API calls by their CUDA correlation id
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the device copies of the scopes (user annotations spanning the
            # kernels launched inside them) are not work
            if not (e.is_user_annotation() or name.startswith(SCOPES) or RUN_RE.fullmatch(name)):
                items.append((name, e.start_ns() / 1e3, e.duration_ns() / 1e3,
                              e.correlation_id(), e.linked_correlation_id()))
            continue
        start, end, thread = e.start_ns() / 1e3, e.end_ns() / 1e3, e.start_thread_id()
        if RUNTIME_RE.match(name):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            runtime[e.correlation_id()] = (thread, start)
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = (thread, start, name)
            if RUN_RE.fullmatch(name):
                windows.append((start, end))
            elif name.startswith(SCOPES):
                spans[thread].append((start, -end, name))
            elif not on_card:
                host_ops.append((thread, start, end, name))
    windows.sort()
    scopes = {thread: Scopes(sp) for thread, sp in spans.items()}
    if on_card:  # (name, device start, duration, launching thread, launch time, operator):
        # the launch is the runtime call with the kernel's correlation id; the
        # operator, where there is one, is the one the profiler links it to
        work = []
        for name, start, dur, corr, linked in items:
            thread, t, op = ops.get(linked, (None, start, ""))
            thread, t = runtime.get(corr, (thread, t))
            work.append((name, start, dur, thread, t, op))
    else:  # host operators with their self time: span less their direct children's
        work = []
        ordered = sorted(host_ops, key=lambda o: (o[0], o[1], -o[2]))
        for thread, thread_ops in itertools.groupby(ordered, key=lambda o: o[0]):
            stack = []  # [name, start, end, self time]
            for _, start, end, name in thread_ops:
                while stack and stack[-1][2] <= start:
                    name_, start_, _, self_ = stack.pop()
                    work.append((name_, start_, self_, thread, start_, name_))
                if stack:
                    stack[-1][3] -= end - start
                stack.append([name, start, end, end - start])
            work += [(n, a, d, thread, a, n) for n, a, _, d in stack]
    per_run = [collections.defaultdict(float) for _ in windows]
    intervals = [[] for _ in windows]
    by_kernel = collections.defaultdict(float)
    for name, start, dur, thread, t, op in work:
        # a run owns what was launched inside its window (the device clock
        # may be offset from the host's)
        run = next((i for i, (a, b) in enumerate(windows) if a <= t <= b), None)
        if run is None:
            continue
        module = attribution(scopes, thread, t) if thread is not None else "(no launcher)"
        per_run[run][category(name, op)] += dur / 1e3
        intervals[run].append((start, start + dur))
        by_kernel[(name, module, category(name, op))] += dur
    busy = [union_us(iv) for iv in intervals]
    print(f"({len(events)} trace events, {len(work)} work items, read in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return windows, per_run, busy, by_kernel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="profile the train step (MI on)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "torch_profile_forward.tsv"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", type=int, nargs=2, default=(576, 960))
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--levels", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    on_card = dev.type == "cuda"
    what = "train step" if args.train else "eval forward"
    events = capture(dev, args.train, args.runs, args.hw, args.points, args.levels, args.batch)
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
    return {"categories": per_run, "busy_share": shares, "windows_ms":
            [(b - a) / 1e3 for a, b in windows], "kernels": len(by_kernel)}


if __name__ == "__main__":
    main()
    sys.exit(0)
