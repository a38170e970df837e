"""Device selection and timing for the port's tools (``scripts/torch_*.py``).

A tool runs on the card unless it is asked for the CPU (``--device cpu``);
asked for a card that is not there, it fails and does not fall back. On the
card a time is the median of CUDA-event times around single calls (the
wrapper's host time included when the card is idle at the start event);
:func:`device_ms` is the kernels' own time from ``torch.profiler`` and
:func:`host_us` the host's time per call. On the CPU a time is the median of
the host clock's, and it is printed as a host time, never as a device
metric.
"""

from __future__ import annotations

import re
import subprocess
import time

import numpy as np
import torch

# Published H100 SXM peaks at 700 W (NVIDIA H100 datasheet): device
# memory bytes/s, f32 operations/s on the CUDA cores, dense TF32 on the
# tensor cores. A kernel's bound is the least time for its function's work:
# each input read once, each output written once, its operations at the
# peak rate of the unit that runs them (max over the two units).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
#: the CUDA runtime calls that put work on the device
_LAUNCH = re.compile(r"^cuda(LaunchKernel|Memset|Memcpy)")


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; raises if it names CUDA and there is no card."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch.cuda.is_available() is False "
                             "(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (one line a card),
    or a line saying the run is on the CPU."""
    if dev.type != "cuda":
        return (f"cpu run ({dev}): no card; times below are host times, and the kernel "
                "wrappers run their plain versions")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, runs: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``runs`` calls: CUDA events around each
    call on the card, the host clock (after a sync) on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_ms(fn, runs: int = 10) -> float:
    """Device ms per call of ``fn`` on the card, from ``torch.profiler``
    (CPU and CUDA activity) over ``runs`` calls after one call outside the
    window: the mean duration of the device activities it recorded
    (kernels, copies, memsets) times the launches the host issued per call.
    CUPTI may hand back fewer activity records than launches in a process
    that has already profiled much, so a fresh process reads it best. Host
    time and the gaps between kernels are not in it. Raises if no device
    activity was recorded."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    ns = [e.duration_ns() for e in events
          if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if not ns:
        raise RuntimeError("device_ms: the profiler recorded no device activity")
    launches = sum(e.device_type() == DeviceType.CPU and _LAUNCH.search(e.name()) is not None
                   for e in events)
    return sum(ns) / len(ns) * max(launches, len(ns)) / runs / 1e6


def host_us(fn, dev: torch.device, calls: int = 1000, rounds: int = 10) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls in ``rounds``
    rounds, each round read on the host clock when its last call returns
    (before the sync that ends it, so the device's time is not in it unless
    the launch queue fills); the median round."""
    fn()
    sync(dev)
    per_round = max(1, calls // rounds)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(per_round):
            fn()
        times.append((time.perf_counter() - t0) / per_round * 1e6)
        sync(dev)
    return float(np.median(times))
