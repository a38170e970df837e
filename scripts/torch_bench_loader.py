#!/usr/bin/env python3
"""The port's host data pipeline at DSEC scale (counterpart of
scripts/bench_loader.py).

    python scripts/torch_bench_loader.py [--mode voxel|dsec|both] [--items 48] [--events 500000]

``voxel`` (no h5py needed): the two event voxelizers at the DSEC sensor
size (480x640, 15 bins) from in-memory events, the native scatter
(``data/native.py``, ``csrc/host_ops.cpp``) against its numpy version:
``dsec.events_to_voxel_trilinear`` (float32 rectified coordinates, time
normalised to [0, 1] as ``DSECTrain.events_to_voxel_inter`` passes it) and
``event_voxel.events_to_voxel`` (integer pixels). Each pair is held to atol
1e-6 and timed (median of ``--repeats`` host-clock runs).

``dsec`` (needs h5py): a synthetic ``train_preprocess_pc`` sequence of
``--items`` items (480x640, a 15-bin voxel, ``--events`` events each, the
JAX script's generator and seed), read through ``DSECPreprocessTrain`` and
the port's ``DataLoader`` in thread and process-pool modes: items/s.

Everything here runs on the host CPU; the card is not used. Each time is a
host time of the machine the command runs on.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rpeflow_tpu_torch.data import dsec, event_voxel  # noqa: E402

H, W, BINS = 480, 640, 15


def synthetic_events(n, h=H, w=W, seed=0):
    """Seeded events: float32 rectified x, y, time in [0, 1] sorted, p in {0, 1}."""
    rng = np.random.RandomState(seed)
    return ((rng.rand(n) * w).astype(np.float32), (rng.rand(n) * h).astype(np.float32),
            np.sort(rng.rand(n)).astype(np.float32), rng.randint(0, 2, n).astype(np.float32))


def host_ms(fn, repeats):
    """(median host ms of ``fn()`` over ``repeats`` runs after one warm-up,
    its last result)."""
    out = fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def voxelizers(n_events, repeats=5, h=H, w=W, bins=BINS):
    """Native against plain for both voxelizers: {name: (native ms, plain
    ms, max |d|)}; raises if a pair differs by more than 1e-6."""
    xs, ys, ts, ps = synthetic_events(n_events, h, w)
    events = np.stack([np.floor(xs), np.floor(ys), ts * 1e5, ps], 1).astype(np.float32)
    pairs = {
        "dsec.events_to_voxel_trilinear": (
            lambda: dsec.events_to_voxel_trilinear(xs, ys, ts, ps, bins, h, w),
            lambda: dsec.events_to_voxel_trilinear_plain(xs, ys, ts, ps, bins, h, w)),
        "event_voxel.events_to_voxel": (
            lambda: event_voxel.events_to_voxel(events, bins, h, w),
            lambda: event_voxel.events_to_voxel_plain(events, bins, h, w)),
    }
    results = {}
    for name, (native, plain) in pairs.items():
        native_ms, got = host_ms(native, repeats)
        plain_ms, want = host_ms(plain, repeats)
        err = float(np.abs(got - want).max())
        results[name] = (native_ms, plain_ms, err)
        print(f"{name:32s} {n_events} events, {h}x{w}, {bins} bins: native {native_ms:.2f} ms, "
              f"numpy {plain_ms:.2f} ms ({plain_ms / native_ms:.1f}x), max |d| {err:.3e}",
              flush=True)
        if err > 1e-6:
            raise AssertionError(f"{name}: native and numpy differ by {err:.3e} > 1e-6")
    return results


def build(root, n_items, n_events, h=H, w=W, bins=BINS):
    """Synthetic preprocessed DSEC items (the JAX script's writer)."""
    import h5py

    d = os.path.join(root, "train_preprocess_pc", "thun_00_a")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n_items):
        disp = rng.rand(h, w).astype(np.float32) * 30 + 5
        with h5py.File(os.path.join(d, f"{i:06d}.hdf5"), "w") as f:
            f["events_x"] = (rng.rand(n_events) * w).astype(np.float32)
            f["events_y"] = (rng.rand(n_events) * h).astype(np.float32)
            f["events_t"] = np.sort(rng.rand(n_events)).astype(np.float32)
            f["events_p"] = rng.randint(0, 2, n_events).astype(np.float32)
            f["event_voxel"] = rng.rand(bins, h, w).astype(np.float32)
            f["image1"] = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            f["image2"] = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            f["flow12"] = rng.randn(h, w, 2).astype(np.float32)
            f["flow12_valid"] = np.ones((h, w), bool)
            f["disp1"] = disp
            f["disp2"] = disp + 0.5
            f["intrinsics"] = np.float32([569.0, 569.0, w / 2, h / 2])
            f["perspectives"] = np.float32([[1, 0, 0, -w / 2], [0, 1, 0, -h / 2],
                                            [0, 0, 0, 569.0], [0, 0, 1.0 / 0.6, 0]])


def bench(root, n_workers, use_pool, batch_size=4, n_points=8192, bins=BINS):
    """items/s of one epoch after a warm-up epoch."""
    from rpeflow_tpu_torch.data import DSECPreprocessTrain
    from rpeflow_tpu_torch.data.loader import DataLoader
    from rpeflow_tpu_torch.train.config import ConfigNode

    cfg = ConfigNode({
        "root_dir": root, "split": "train", "data_seq": "full", "isbi": False,
        "n_workers": n_workers, "max_depth": 35, "max_flow": 100, "max_3dflow": 2.0,
        "n_points": n_points, "use_preprocess": True, "event_bins": bins,
        "event_polarity": False, "augmentation": {"enabled": False},
    })
    loader = DataLoader(DSECPreprocessTrain(cfg), batch_size, shuffle=False,
                        num_workers=n_workers, use_process_pool=use_pool)
    try:
        for _ in loader:  # warm-up epoch (page cache, pool start-up)
            pass
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += batch["images"].shape[0]
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    tag = f"pool x{n_workers}" if use_pool else f"thread x{n_workers}"
    print(f"{tag:12s}: {n / dt:6.1f} items/s  ({dt / n * 1000:.1f} ms/item)", flush=True)
    return n / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("voxel", "dsec", "both"), default="both")
    ap.add_argument("--items", type=int, default=48)
    ap.add_argument("--events", type=int, default=500_000)
    ap.add_argument("--hw", type=int, nargs=2, default=(H, W))
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--workers", type=int, nargs="+", default=(1, 2, 4),
                    help="worker counts: thread mode at each, process pool above 1")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    h, w = args.hw
    print(f"host: {os.cpu_count()} CPUs; times are host times", flush=True)
    if args.mode in ("voxel", "both"):
        voxelizers(args.events, args.repeats, h, w)
    if args.mode in ("dsec", "both"):
        root = tempfile.mkdtemp(prefix="dsec_loader_bench_")
        try:
            t = time.time()
            build(root, args.items, args.events, h, w)
            print(f"[dsec-preprocessed] built {args.items} synthetic items in "
                  f"{time.time() - t:.0f}s ({h}x{w}, 15-bin voxel, {args.events} events each)",
                  flush=True)
            for n_workers in args.workers:
                bench(root, n_workers, False, n_points=args.points)
                if n_workers > 1:
                    bench(root, n_workers, True, n_points=args.points)
        finally:
            if not args.keep:
                shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
