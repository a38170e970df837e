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

:func:`span` is the program's own scope: the train step, the forward and
the metric sums open ``rpeflow.<phase>`` spans with it, which a trace shows
beside the module scopes while :func:`record_spans` is on (in
:func:`capture`'s traces and the trainer's). :func:`analyse` treats them
as scopes, not as operators; :func:`span_table` reads, per span, its wall
time, the device's busy and idle time inside it and the device time of
the work launched inside it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import re
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _profiler

from ..ops import _cuda
from .timing import sync

RUN_RE = re.compile(r"run\d+")
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
#: the prefix of the program's own spans (:func:`span`)
SPAN = "rpeflow."
SCOPES = ("module::", AUTOGRAD_NODE, SPAN)
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


_OFF = contextlib.nullcontext()
_recording = False  # record_spans


def record_spans(on: bool) -> None:
    """Whether :func:`span` records in a ``torch.profiler`` trace. On in
    the port's own traces (:func:`capture`, the trainer's
    ``log.profile_steps``), whose readers take the spans for scopes; off
    elsewhere, so that a reader that takes any named host span around an
    idle gap for the operator running there reads the trace it read
    before the spans."""
    global _recording
    _recording = on


def span(name: str):
    """A profiler span ``name`` (``rpeflow.<phase>``) around a ``with``
    block: ``record_function(name)`` while a ``torch.profiler`` records
    and :func:`record_spans` is on, so the span lands in the trace on the
    clock of the device work; else a no-op context that costs a flag read
    (an unused ``record_function`` still enters the dispatcher, about
    10 us a call). Spans stay out of code that an activation checkpoint
    re-runs, so the backward's recompute opens none on the autograd
    thread."""
    if _recording and _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


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
    :class:`ModuleScopes` on ``model`` and the program's spans on
    (:func:`record_spans`); returns the profiler's raw (kineto) events."""
    run(batches[0])  # warm-up
    sync(dev)
    scopes = ModuleScopes(model)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    record_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            for i, bt in enumerate(batches[1:]):
                with torch.autograd.profiler.record_function(f"run{i}"):
                    run(bt)
                    sync(dev)
    finally:
        record_spans(False)
        scopes.remove()
    return prof.profiler.kineto_results.events()


def _read(events, on_card):
    """The runs' windows (sorted), each host thread's :class:`Scopes`, the
    program's spans ``(start, end, name)`` and the work items ``(name,
    start, duration, launching thread, launch time, operator)``, in us. On
    the card the work items are the device events (kernels, memcpy,
    memset), each found its launch (the runtime call) through its
    correlation id; on the CPU they are the host operators with their self
    time."""
    windows, spans, program, items, host_ops = [], collections.defaultdict(list), [], [], []
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
                if name.startswith(SPAN):
                    program.append((start, end, name))
            elif not on_card:
                host_ops.append((thread, start, end, name))
    windows.sort()
    scopes = {thread: Scopes(sp) for thread, sp in spans.items()}
    if on_card:  # the launch is the runtime call with the kernel's correlation
        # id; the operator, where there is one, is the one the profiler links it to
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
    return windows, scopes, sorted(program), work


def _run_of(windows, t):
    """The run whose window holds ``t`` (the device clock may be offset
    from the host's, so a run owns what was launched inside it), or None."""
    return next((i for i, (a, b) in enumerate(windows) if a <= t <= b), None)


def analyse(events, on_card):
    """Per run: category totals (ms), busy us and window us; over all runs:
    (name, module, category) -> total us (the work items of :func:`_read`)."""
    t0 = time.perf_counter()
    windows, scopes, _, work = _read(events, on_card)
    per_run = [collections.defaultdict(float) for _ in windows]
    intervals = [[] for _ in windows]
    by_kernel = collections.defaultdict(float)
    for name, start, dur, thread, t, op in work:
        run = _run_of(windows, t)
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


def span_table(events) -> dict:
    """The program's spans in a card's trace (of :func:`capture`), per run
    (the mean over the runs): for each span name, in order of first start,
    its ``count``, ``wall_ms``, ``busy_ms`` (the union of the device work
    clipped to it), ``idle_pct`` (its wall time in which the card ran
    nothing), ``launched_ms`` (device time of the work launched inside it)
    and ``top_ms`` (the part of that launched by ``top_module``, the module
    with the most device time: the ``.level<k>`` rows split it by decode
    level); ``idle_ms`` and ``idle_outside_spans_ms`` (the card's idle time
    in the windows, and its part outside every span); ``least_lag_us``, the
    least time from a kernel's launch call to its start on the device, and
    ``lags_below_0``: a lag below 0 means that the profiler's device clock
    is offset from the host's, and the spans from the work by as much."""
    windows, scopes, program, work = _read(events, True)
    runs = max(len(windows), 1)
    kept, per_module = [], collections.Counter()
    for name, start, dur, thread, t, _ in work:
        if _run_of(windows, t) is not None:
            module = attribution(scopes, thread, t) if thread is not None else "(no launcher)"
            kept.append((t, start, dur, name, module))
            per_module[module] += dur
    kept.sort()
    launches = [k[0] for k in kept]
    top = per_module.most_common(1)[0][0] if per_module else None
    busy = []  # the work's union inside the windows: sorted disjoint [start, end]
    for a, b in windows:
        for x, y in sorted((max(s, a), min(s + d, b)) for t, s, d, _, _ in kept
                           if a <= t <= b and min(s + d, b) > max(s, a)):
            if busy and x <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], y)
            else:
                busy.append([x, y])
    busy_starts = [x for x, _ in busy]

    def busy_in(a, b):
        k, us = max(bisect.bisect_right(busy_starts, a) - 1, 0), 0.0
        while k < len(busy) and busy[k][0] < b:
            us += max(0.0, min(busy[k][1], b) - max(busy[k][0], a))
            k += 1
        return us

    program = [sp for sp in program if _run_of(windows, sp[0]) is not None]
    rows = {}
    for a, b, name in program:
        row = rows.setdefault(name, [0, 0.0, 0.0, 0.0, 0.0])
        inside = kept[bisect.bisect_left(launches, a):bisect.bisect_right(launches, b)]
        row[0] += 1
        row[1] += b - a
        row[2] += busy_in(a, b)
        row[3] += sum(k[2] for k in inside)
        row[4] += sum(k[2] for k in inside if k[4] == top)
    outermost = [(a, b) for a, b, _ in program
                 if not any(a2 <= a and b <= b2 and (a2, b2) != (a, b) for a2, b2, _ in program)]
    idle = sum(b - a for a, b in windows) - sum(y - x for x, y in busy)
    lags = [s - t for t, s, _, name, module in kept if module != "(no launcher)"
            and not name.lower().startswith(("memcpy", "memset"))]
    return {
        "runs": len(windows), "top_module": top,
        "spans": {name: {"count": n / runs, "wall_ms": wall / 1e3 / runs,
                         "busy_ms": b / 1e3 / runs,
                         "idle_pct": 100.0 * (wall - b) / wall if wall else None,
                         "launched_ms": launched / 1e3 / runs, "top_ms": top_us / 1e3 / runs}
                  for name, (n, wall, b, launched, top_us) in rows.items()},
        "idle_ms": idle / 1e3 / runs,
        "idle_outside_spans_ms": (idle - sum(b - a - busy_in(a, b) for a, b in outermost))
        / 1e3 / runs,
        "least_lag_us": min(lags) if lags else None,
        "lags_below_0": sum(lag < 0 for lag in lags),
    }
