#!/usr/bin/env python3
"""Host cost of launching each kernel under its input's device.

    python3 scripts/torch_launch_guard.py

Every kernel wrapper launches inside ``_cuda.on_device(x.device)``: the
input's device made current (``torch.cuda.device``) and its current stream
looked up. This times, on the first card, the guard alone and the smallest
depthwise-conv and MDTA wrapper calls with the guard and with it replaced by
a bare stream lookup (the launches before the guard existed): host
microseconds per call, median of 5 rounds of 2000 calls each, synced at
the end of each round.
"""

import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpeflow_tpu_torch.ops import _cuda, dwconv, mdta  # noqa: E402


def host_us(fn, calls=2000, rounds=5):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


@contextlib.contextmanager
def stream_only(device):
    yield _cuda.stream(device)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda:0")
    _cuda.lib()
    x = torch.randn(1, 1, 16, 32, device=dev)
    taps = torch.randn(3, 3, 32, device=dev)
    ln, dw = torch.ones(4, 32, device=dev), torch.ones(1, 3, 96, device=dev)

    def guard():
        with _cuda.on_device(dev):
            pass

    calls = {"dwconv_fwd (1, 1, 16, 32)": lambda: dwconv.dwconv_fwd(x, taps),
             "mdta_qkv (1, 1, 16, 32), kh 1": lambda: mdta.mdta_qkv(x, x, ln, dw, 1)}
    print(f"on_device alone: {host_us(guard):.2f} us")
    guarded = _cuda.on_device
    for name, fn in calls.items():
        rows = []
        for label, ctx in (("guard", guarded), ("stream only", stream_only),
                           ("stream only", stream_only), ("guard", guarded)):
            _cuda.on_device = ctx
            rows.append(f"{label} {host_us(fn):.2f}")
        _cuda.on_device = guarded
        print(f"{name}, host us per call: " + ", ".join(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
