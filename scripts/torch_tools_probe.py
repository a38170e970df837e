#!/usr/bin/env python3
"""Where the tools' zero store and lane gather spend their time, and their
times under other plans.

    python3 scripts/torch_tools_probe.py [--plans] [--host] [--json]

On the first card, each kernel wrapper and the PyTorch call that computes
the same function (its yardstick), at the tools' shapes:

* ``ops.zero_store.zero_store`` at the repro's [2, 144, 240, 256], tile 8,
  beside ``torch.zeros`` (70.8 MB written: 21.1 us at 3.35 TB/s);
* ``ops.gather.gather_lanes`` at the gather tool's table [4, 128, 8192] f32
  and idx [4, 131072] int32, beside ``torch.gather`` on the channels-first
  table (287.3 MB moved: 85.8 us at 3.35 TB/s), and ``gather_rows`` on the
  same table channels-last, beside ``torch.gather`` there.

For each: exactly equal to the plain version, then the CUDA-event ms of one
call (median of 20, the wrapper's host time included, as
``utils/timing.py : time_ms`` and ``chip_smoke.py`` time it), the device ms
of its kernels alone (``torch.profiler``) and the host microseconds per call
(1000 calls). ``--plans`` also times the lane gather's staged branch at
g = 1, 2, 4 channels a block, 128, 256 and 512 threads a block and M in 1 or
2 splits (and g = 7), and its L2 branch, each checked the same way.
``--host`` splits the zero store wrapper's host time per call into its
parts (the output's allocation, the launch guard, the ctypes launch alone)
beside ``torch.zeros``'s. ``--json`` ends the output with one JSON line of
each call's three times (``chip_smoke.py`` phase 11 reads it: a fresh
process, where the profiler hands back every kernel's record).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rpeflow_tpu_torch.ops import _cuda, gather, zero_store  # noqa: E402
from rpeflow_tpu_torch.utils.timing import (  # noqa: E402
    PEAK_BYTES,
    card_line,
    device_ms,
    host_us,
    resolve_device,
    time_ms,
)

ZERO_SHAPE, ZERO_TILE = (2, 144, 240, 256), 8
B, C, N, K = 4, 128, 8192, 16
#: (g, threads, splits) of the lane gather's plans timed by --plans
LANE_PLANS = [(g, t, s) for g in (1, 2, 4) for t in (128, 256, 512) for s in (1, 2)]
LANE_PLANS += [(7, 256, 1)]


def measure(name, fn, want, dev, bound_ms, host=True):
    """Check ``fn()`` equals ``want`` exactly, then print and return its
    (event ms, device ms, host us)."""
    got = fn()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from the plain version")
    ms, dms = time_ms(fn, dev), device_ms(fn)
    hus = host_us(fn, dev) if host else float("nan")
    print(f"  {name:44s} event {ms:8.4f} ms  device {dms:8.4f} ms  host {hus:6.1f} us  "
          f"({dms / bound_ms:.2f}x the bound's {bound_ms:.4f} ms by device time)", flush=True)
    return ms, dms, hus


def zero(dev):
    x = torch.randn(*ZERO_SHAPE, device=dev)
    want = zero_store.zero_store_plain(x, ZERO_TILE)
    bound_ms = x.numel() * 4 / PEAK_BYTES * 1e3
    print(f"zero store {ZERO_SHAPE} tile {ZERO_TILE}", flush=True)
    return {
        "torch.zeros": measure("torch.zeros (library)", lambda: torch.zeros(x.shape, device=dev),
                               want, dev, bound_ms),
        "zero_store": measure("zero_store (default)", lambda: zero_store.zero_store(x, ZERO_TILE),
                              want, dev, bound_ms),
        "torch.zeros again": measure("torch.zeros (library), again",
                                     lambda: torch.zeros(x.shape, device=dev), want, dev,
                                     bound_ms)}


def gathers(dev, plans):
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(B, C, N, generator=g, device=dev)
    table_rows = table.transpose(1, 2).contiguous()
    idx = torch.randint(0, N, (B, N * K), generator=g, device=dev, dtype=torch.int32)
    want = gather.gather_lanes_plain(table, idx)
    want_rows = gather.gather_rows_plain(table_rows, idx)
    lanes_index = idx.long()[:, None, :].expand(B, C, N * K)
    rows_index = idx.long()[..., None].expand(B, N * K, C)
    nbytes = (want.numel() + table.numel()) * 4 + idx.numel() * 4
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"gathers: table [{B}, {C}, {N}] f32 (and channels-last), idx [{B}, {N * K}] int32",
          flush=True)
    res = {
        "torch.gather rows": measure("torch.gather rows (library)",
                                     lambda: torch.gather(table_rows, 1, rows_index), want_rows,
                                     dev, bound_ms),
        "gather_rows": measure("gather_rows", lambda: gather.gather_rows(table_rows, idx),
                               want_rows, dev, bound_ms),
        "torch.gather lanes": measure("torch.gather lanes (library)",
                                      lambda: torch.gather(table, 2, lanes_index), want, dev,
                                      bound_ms),
        "gather_lanes": measure("gather_lanes (default)", lambda: gather.gather_lanes(table, idx),
                                want, dev, bound_ms)}
    if plans:
        print(f"  (default plan {gather.lanes_plan(B, C, N, N * K, 4, _cuda.sm_count(dev))})",
              flush=True)
        for plan in [gather.LanesPlan(*p) for p in LANE_PLANS] + [gather.LanesPlan(0, 256, 1)]:
            measure(f"gather_lanes {plan}", lambda: gather.launch_lanes(table, idx, plan), want,
                    dev, bound_ms, host=False)
    res["torch.gather lanes again"] = measure(
        "torch.gather lanes (library), again", lambda: torch.gather(table, 2, lanes_index), want,
        dev, bound_ms)
    return res


def host_split(dev):
    """The zero store wrapper's host us per call, by part, beside
    torch.zeros's (each part timed alone, 1000 calls)."""
    x = torch.randn(*ZERO_SHAPE, device=dev)
    out = torch.empty_like(x)
    lib = _cuda.lib()
    stream = _cuda.stream(dev)

    def guard():
        with _cuda.on_device(dev):
            pass

    parts = {
        "torch.zeros": lambda: torch.zeros(x.shape, device=dev),
        "zero_store (the wrapper)": lambda: zero_store.zero_store(x, ZERO_TILE),
        "torch.empty of the output": lambda: torch.empty(x.shape, device=dev),
        "on_device (the launch guard)": guard,
        "torch.cuda.current_device": torch.cuda.current_device,
        "ctypes launch alone": lambda: lib.rpeflow_zero_store(out.data_ptr(), out.numel(),
                                                              stream),
    }
    print("host us a call, zero store at its repro shape", flush=True)
    for name, fn in parts.items():
        print(f"  {name:32s} {host_us(fn, dev):7.2f} us", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true", help="also time other plans")
    ap.add_argument("--host", action="store_true", help="split the zero store's host time")
    ap.add_argument("--json", action="store_true", help="end with a JSON line of the times")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_line(dev), flush=True)
    if args.host:
        host_split(dev)
    res = {**zero(dev), **gathers(dev, args.plans)}
    if args.json:
        print(json.dumps({name: dict(zip(("ms", "device_ms", "host_us"), r))
                          for name, r in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
