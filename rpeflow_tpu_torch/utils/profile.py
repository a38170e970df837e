"""Device time of a profiled workload by category and by launching module
(used by ``scripts/torch_profile_forward.py`` and the bench's traced run,
``rpeflow_tpu_torch.bench``).

:func:`capture` profiles runs of a workload under ``torch.profiler`` (CPU
and CUDA activities), each on its own batch and ending in a device sync,
each inside a ``run<i>`` scope, with a ``module::<name>`` scope around every
submodule's forward (:class:`ModuleScopes`). :func:`analyse` reads the
trace: per run, device time by :func:`category` (each hand-written kernel
by name, cuDNN conv with its FFT and layout kernels, GEMM, elementwise,
reduce, topk/sort, memcpy/memset, other) and the device-busy time (the
union of the kernel, memcpy and memset intervals) beside the run's window;
over all runs, the time of each kernel with the module that launched it. A
kernel's launch is found through its correlation id, and its module is the
innermost ``module::`` scope above the launch. Activation checkpoints re-run
a block's forward inside the backward, on the autograd thread, and may stop
it early by an exception: the per-thread stacks and the always-called hook
keep the scopes paired, and those scopes are named ``module::<name>
[recompute]``. A kernel of the backward outside any scope is attributed to
its autograd node (``backward: <node>``). On the CPU there are no device
events: the same tables are made of the host's operators and their self
time.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import re
import threading
import time

import torch
from torch.autograd import DeviceType

from ..ops import _cuda
from .timing import sync

RUN_RE = re.compile(r"run\d+")
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
SCOPES = ("module::", AUTOGRAD_NODE)
RUNTIME_RE = re.compile(r"cu(da)?[A-Z]")
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


def capture(model, run, batches, dev):
    """Run ``run(batches[0])`` as a warm-up, then profile ``run`` on each
    further batch (a ``run<i>`` scope each, ending in a device sync) with
    :class:`ModuleScopes` on ``model``; returns the profiler's raw (kineto)
    events."""
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
