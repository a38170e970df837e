"""The traced run's reading of a ``torch.profiler`` trace (the arithmetic of
``rpeflow_tpu_torch/utils/profile.py`` copied: the categories, the module
scopes, the innermost scope around a launch, the busy union).

:func:`capture` profiles runs of a workload under ``torch.profiler`` (CPU
and CUDA activities), each inside a ``run<i>`` scope and ending in a device
sync, with a ``module::<name>`` scope around every submodule's forward of
the program (:class:`ModuleScopes`). :func:`read` turns the raw events into
a :class:`Trace`: every device work item (kernel, memcpy, memset) launched
inside a run, with its category and the innermost module scope around its
launch; each run's window and the union of its work (busy time); and the
idle time between the work, summed by what the host was running when the
device went idle (its innermost operator and module scope; the profiler's
own ``Activity Buffer Request`` shows as such).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import threading

import torch
from torch.autograd import DeviceType

from .work import HAND_KERNELS

RUN_RE = re.compile(r"run\d+")
AUTOGRAD_NODE = "autograd::engine::evaluate_function: "
SCOPES = ("module::", AUTOGRAD_NODE)
RUNTIME_RE = re.compile(r"cu(da)?[A-Z]")
_HAND_RE = re.compile(r"(?:^|::|\s)(" + "|".join(sorted(HAND_KERNELS, key=len, reverse=True))
                      + r")\b")
#: (category, pattern on the lower-cased kernel or operator name), first match wins
CATEGORIES = [
    ("memcpy/memset", r"memcpy|memset|aten::copy_|aten::fill_|aten::zero_"),
    ("cuDNN conv", r"cudnn|conv|fft|winograd|implicit|dgrad|wgrad|fprop|cgemm|nchw|nhwc"),
    ("GEMM", r"gemm|gemv|cutlass|cublas|matmul|\baten::(mm|bmm|addmm|baddbmm|linear)\b"),
    ("topk/sort", r"topk|sort|radix|bitonic|cub::"),
    ("reduce", r"reduce|norm|softmax|\baten::(sum|mean|max|min|amax|argmax|argmin|prod)\b"),
    ("elementwise", r"elementwise|vectorized|unrolled|^aten::"),  # ^: a host operator
]


def hand_kernel(name: str) -> str | None:
    """The counted function (:data:`~.work.HAND_KERNELS`) a device kernel of
    this name runs, or None for a kernel that is not hand-written."""
    m = _HAND_RE.search(name)
    return HAND_KERNELS[m.group(1)] if m else None


def category(name: str, op: str = "") -> str:
    """The category of a kernel ``name`` launched by the operator ``op``: a
    hand-written kernel by its function, else the first pattern that matches
    the kernel's or its operator's name (the FFT convolution's complex GEMMs
    and transforms belong to the conv that launched them)."""
    key = hand_kernel(name)
    if key:
        return f"kernel {key}"
    text = (name if op in ("", name) else f"{name} | {op}").lower()
    for cat, pattern in CATEGORIES:
        if re.search(pattern, text):
            return cat
    return "other"


class ModuleScopes:
    """``module::<name>`` profiler scopes around every submodule's forward.
    Activation checkpoints re-run a block's forward inside the backward, on
    the autograd thread, and may stop it early by an exception: the
    per-thread stacks and the always-called hook keep the scopes paired, and
    those scopes are named ``module::<name> [recompute]``."""

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
    """Properly nested host spans of one thread, for finding the innermost
    ones around a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, -end, name)
        self.starts = [sp[0] for sp in self.spans]
        self.parent, stack = [], []
        for i, (start, neg_end, _) in enumerate(self.spans):
            while stack and -self.spans[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t):
        """Names of the spans around ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        names = []
        while i >= 0:
            start, neg_end, name = self.spans[i]
            if start <= t <= -neg_end:
                names.append(name)
            i = self.parent[i]
        return names


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Item:
    """One piece of device work launched inside a traced run."""
    name: str
    kind: str        # "kernel", "memcpy" or "memset"
    start_us: float
    dur_us: float
    module: str      # innermost module scope around its launch, or "(no module)"
    category: str
    hand: str | None  # the counted function of a hand-written kernel
    run: int


@dataclasses.dataclass
class Trace:
    """What a traced run read, and what the benchmark adds to it for the
    per-layer readers (:mod:`benchmark.metrics`). Times in seconds unless
    named otherwise."""
    iterations: int
    windows_s: list          # each run's window
    busy_s: float            # union of the device work inside the windows
    items: list              # Item
    gaps: list               # (seconds idle, what the host ran when the device went idle),
                             # summed by what the host ran, longest first
    # from the reference at the cell's shapes, per iteration
    flops_per_iter: float = 0.0
    calls: list = dataclasses.field(default_factory=list)  # (counted function, shape)
    conv_modules: frozenset = frozenset()   # names of the program's conv blocks
    conv_least_s: float = 0.0               # their least time in one iteration
    peak_bytes: int = 0                     # allocated-memory peak over the traced runs

    @property
    def window_s(self) -> float:
        return sum(self.windows_s)


def capture(model, run, batches, sync):
    """Profile ``run`` on each batch (a ``run<i>`` scope each, ending in
    ``sync()``) with :class:`ModuleScopes` on ``model``; returns the
    profiler's raw (kineto) events."""
    scopes = ModuleScopes(model)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            for i, bt in enumerate(batches):
                with torch.autograd.profiler.record_function(f"run{i}"):
                    run(bt)
                    sync()
    finally:
        scopes.remove()
    return prof.profiler.kineto_results.events()


def _kind(name: str) -> str:
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") \
        else "kernel"


def _label(names) -> str:
    """What a host thread ran at a time, from the spans around it (innermost
    first): its innermost operator and module scope."""
    op = next((n for n in names if not n.startswith(SCOPES) and not RUN_RE.fullmatch(n)), None)
    module = next((n[len("module::"):] for n in names if n.startswith("module::")), None)
    if op is None and module is None:
        return "(no host operator)"
    return " in ".join(x for x in (op or "python", module) if x)


def read(events, gaps: int = 10) -> Trace:
    """The :class:`Trace` of the raw events of :func:`capture`. A work item
    belongs to the run inside whose window it was launched (the device clock
    may be offset from the host's); its launch is the runtime call with its
    correlation id, and its module the innermost ``module::`` scope around
    that launch, else its autograd node (``backward: <node>``)."""
    windows, host, items = [], collections.defaultdict(list), []
    ops, runtime = {}, {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(SCOPES) or RUN_RE.fullmatch(name)):
                items.append((name, e.start_ns() / 1e3, e.duration_ns() / 1e3,
                              e.correlation_id(), e.linked_correlation_id()))
            continue
        start, end, thread = e.start_ns() / 1e3, e.end_ns() / 1e3, e.start_thread_id()
        if RUNTIME_RE.match(name):
            runtime[e.correlation_id()] = (thread, start)
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = (thread, start, name)
            if RUN_RE.fullmatch(name):
                windows.append((start, end))
            host[thread].append((start, -end, name))
    windows.sort()
    scopes = {thread: Scopes(sp) for thread, sp in host.items()}
    starts = [a for a, _ in windows]
    out, per_run = [], [[] for _ in windows]
    for name, start, dur, corr, linked in items:
        thread, t, op = ops.get(linked, (None, start, ""))
        thread, t = runtime.get(corr, (thread, t))
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > windows[i][1]:
            continue
        module = "(no launcher)"
        if thread in scopes:
            around = scopes[thread].around(t)
            module = next((n[len("module::"):] for n in around if n.startswith("module::")),
                          None) or next((("backward: " + n[len(AUTOGRAD_NODE):])
                                         for n in around if n.startswith(AUTOGRAD_NODE)),
                                        "(no module)")
        out.append(Item(name, _kind(name), start, dur, module, category(name, op),
                        hand_kernel(name), i))
        per_run[i].append((start, start + dur))
    busy, idle = 0.0, []
    for (a, b), intervals in zip(windows, per_run):
        merged = union((max(x, a), min(y, b)) for x, y in intervals if min(y, b) > max(x, a))
        busy += sum(y - x for x, y in merged)
        edges = [a] + [v for iv in merged for v in iv] + [b]
        idle += [(edges[k + 1] - edges[k], edges[k])
                 for k in range(0, len(edges) - 1, 2) if edges[k + 1] > edges[k]]
    by_label = collections.Counter()
    for length, t in idle:
        labels = [_label(s.around(t)) for s in scopes.values()]
        label = next((x for x in labels if not x.startswith("python") and x[0] != "("),
                     next((x for x in labels if x[0] != "("), "(no host operator)"))
        by_label[label] += length / 1e6
    named = [(s, label) for label, s in by_label.most_common(gaps)]
    return Trace(iterations=len(windows), windows_s=[(b - a) / 1e6 for a, b in windows],
                 busy_s=busy / 1e6, items=out, gaps=named)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device work that took most time, by category and launching module,
    and the idle time by what the host ran when the device went idle:
    seconds over the traced runs."""
    by = collections.Counter()
    for it in trace.items:
        by[f"{it.category} @ {it.module}"] += it.dur_us / 1e6
    return {"device_ops": [[k, v] for k, v in by.most_common(top)],
            "idle_gaps": [[label, s] for s, label in trace.gaps[:top]]}
