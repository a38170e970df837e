#!/usr/bin/env python3
"""Microbenchmark of the KNN-gather formulations on the card (the port's
counterpart of scripts/bench_gather.py).

    python scripts/torch_bench_gather.py [a b c d e] [--device cuda]
    python scripts/torch_bench_gather.py sweep

A table ``[B, N, C]`` (or ``[B, C, N]`` channels-first) is gathered at
``idx [B, M]`` with M = N * K (B = 4, N = 8192, K = 16, C = 128 by default):

  A) the library's row gather, ``torch.gather`` on ``[B, N, C]``;
  B) the library's lane gather, ``torch.gather`` on ``[B, C, N]``;
  C) ``ops.gather.gather_rows`` (csrc/gather.cu; replaces ``pallas_rows``):
     whole rows, 16-byte words, a warp a row;
  D) ``ops.gather.gather_lanes`` (csrc/gather.cu; replaces ``pallas_lanes``):
     at this shape its staged branch, each block's 4 table rows (128 KB)
     copied into shared memory by the TMA engine, then written out four m a
     thread (``ops.gather.lanes_plan``; rows over 227 KB go through the L2);
  E) ``pallas_rowloop`` computes the same function as ``pallas_rows``, so the
     port has one kernel for both: E is C, printed once more under its
     letter, neither checked nor timed a second time.

Each variant is first held to its plain version (``gather_rows_plain`` /
``gather_lanes_plain``) for exact equality; a variant that differs or fails
raises. Times are the median of 20 calls between CUDA events (the wrapper's
host time included), and on the card, beside it, the device time of the
kernels alone (``torch.profiler``, 10 calls); effective GB/s and the bound
count the bytes the
function must move: the output written once, the table and the indices read
once (287.3 MB at the default shape, 85.8 us at 3.35 TB/s; both gathers are
bound by those bytes). ``sweep`` times A and C over C in
{8, 32, 64, 128, 256} float32 and {128, 256} bfloat16 (GB/s of the output
rows, ns a row).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rpeflow_tpu_torch.ops import _cuda  # noqa: E402
from rpeflow_tpu_torch.ops.gather import (  # noqa: E402
    gather_lanes,
    gather_lanes_plain,
    gather_rows,
    gather_rows_plain,
)
from rpeflow_tpu_torch.utils.timing import (  # noqa: E402
    PEAK_BYTES,
    card_line,
    device_ms,
    resolve_device,
    time_ms,
)

SWEEP = [(8, torch.float32), (32, torch.float32), (64, torch.float32), (128, torch.float32),
         (256, torch.float32), (128, torch.bfloat16), (256, torch.bfloat16)]


def make_inputs(b, n, k, c, dev, dtype=torch.float32, seed=0):
    """Seeded table ``[B, N, C]``, its channels-first copy and ``idx [B, N * K]``."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.randint(0, n, size=(b, n * k)).astype(np.int32)).to(dev)
    return table, table.transpose(1, 2).contiguous(), idx


def variants(table, table_cf, idx):
    """letter -> (printed name, the variant, its plain version)."""
    idx64 = idx.long()
    b, n, c = table.shape
    m = idx.shape[1]
    rows_index = idx64[..., None].expand(b, m, c)
    lanes_index = idx64[:, None, :].expand(b, c, m)
    return {
        "a": ("A torch.gather rows (library)",
              lambda: torch.gather(table, 1, rows_index), lambda: gather_rows_plain(table, idx)),
        "b": ("B torch.gather lanes (library, cf)",
              lambda: torch.gather(table_cf, 2, lanes_index),
              lambda: gather_lanes_plain(table_cf, idx)),
        "c": ("C gather_rows kernel", lambda: gather_rows(table, idx),
              lambda: gather_rows_plain(table, idx)),
        "d": ("D gather_lanes kernel (cf)", lambda: gather_lanes(table_cf, idx),
              lambda: gather_lanes_plain(table_cf, idx)),
    }


def run(which, b, n, k, c, dev, runs=20, device_time=True):
    """Check and time the chosen variants; returns {letter: (ms, GB/s, max
    |variant - plain|, device ms)} (E, asked for, is C's entry; device ms
    is None on the CPU or without ``device_time``)."""
    table, table_cf, idx = make_inputs(b, n, k, c, dev)
    nbytes = (b * n * k * c + b * n * c) * table.element_size() + idx.numel() * idx.element_size()
    out_bytes = b * n * k * c * table.element_size()
    bound_ms = nbytes / PEAK_BYTES * 1e3
    letters = set(which) | ({"c"} if "e" in which else set())
    chosen = {w: v for w, v in variants(table, table_cf, idx).items() if w in letters}
    errs = {}
    for w, (name, fn, plain) in chosen.items():
        got, want = fn(), plain()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        errs[w] = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from the plain version (max |d| {errs[w]})")
        print(f"{name}: equal to the plain version", flush=True)
    print(f"B={b} N={n} K={k} C={c} M={n * k}: output {out_bytes / 1e6:.1f} MB, table "
          f"{b * n * c * table.element_size() / 1e6:.1f} MB, idx {idx.numel() * 4 / 1e6:.1f} MB; "
          f"{nbytes / 1e6:.1f} MB a call, bound {bound_ms * 1e3:.1f} us at 3.35 TB/s", flush=True)
    results = {}
    for w, (name, fn, _) in chosen.items():
        before = dict(_cuda.LAUNCHES)
        ms = time_ms(fn, dev, runs=runs)
        launched = {key: v - before[key] for key, v in _cuda.LAUNCHES.items() if v != before[key]}
        dev_ms = device_ms(fn) if dev.type == "cuda" and device_time else None
        results[w] = (ms, nbytes / (ms * 1e-3) / 1e9, errs[w], dev_ms)
        on_card = "" if dev_ms is None else f", device {dev_ms:.4f} ms"
        print(f"{name}: {ms:.4f} ms{on_card}, {results[w][1]:.1f} GB/s effective, "
              f"{ms / bound_ms:.2f}x the bound; launches {launched or 'none (library)'}",
              flush=True)
    if "e" in which:
        results["e"] = results["c"]
        print("E gather_rows kernel: the same kernel as C (pallas_rowloop computes the same "
              "function as pallas_rows); see C", flush=True)
    return results, bound_ms


def sweep(b, n, k, dev):
    """A and C across row widths and types: GB/s of the rows, ns a row."""
    for c, dtype in SWEEP:
        table, _, idx = make_inputs(b, n, k, c, dev, dtype)
        idx64 = idx.long()[..., None].expand(b, n * k, c)
        want = gather_rows_plain(table, idx)
        for name, fn in (("A torch.gather", lambda: torch.gather(table, 1, idx64)),
                         ("C gather_rows", lambda: gather_rows(table, idx))):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} C={c} {dtype}: differs from the plain version")
            ms = time_ms(fn, dev)
            row_bytes = b * n * k * c * table.element_size()
            print(f"{name:16s} C={c:<4d} {str(dtype):15s} {ms:.4f} ms  rows {b * n * k / 1e3:.0f}k "
                  f"x {c * table.element_size()} B -> {row_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                  f"{ms * 1e6 / (b * n * k):.3f} ns/row", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", default=["a", "b", "c", "d", "e"],
                    help="variants among a-e, or 'sweep'")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--c", type=int, default=128)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    if "sweep" in args.which:
        sweep(args.b, args.n, args.k, dev)
        return 0
    run(args.which, args.b, args.n, args.k, args.c, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
