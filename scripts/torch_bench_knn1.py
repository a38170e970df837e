#!/usr/bin/env python3
"""Microbenchmark of k = 1 nearest-neighbour formulations at the decode
level-1 shape (the port's counterpart of scripts/bench_knn1.py).

    python scripts/torch_bench_knn1.py [--device cuda] [--b 4 --q 34560 --n 4096 --d 2]

B = 4 batches of Q = 34560 queries (the 144x240 pixel grid of decode level
1) against N = 4096 points in D = 2, as in the JAX script:

  current            the port's ``ops/knn.py : k_nearest_neighbor``, k = 1
                     (the matmul form, queries chunked to 512 MB blocks);
  broadcast full     ``(q - p)^2`` summed over D for every pair at once: a
                     [B, Q, N, D] difference (4.5 GB of float32 here), argmin;
  broadcast chunked  the same over query chunks of 4320;
  matmul full        ``ops/knn.py : squared_distance`` over every pair at
                     once ([B, Q, N], 2.3 GB), argmin.

Each is timed on the JAX script's inputs (``rand * 100`` from seed 0) over
20 iterations between two CUDA events after one warm-up call. As in the JAX
loop, each iteration's query is the last one plus ``0.0 *`` the previous
iteration's first index, so every call waits for the one before it and
reads a fresh tensor; the run ends with a sync on the last output. Printed:
ms a call, the peak device memory of the variant's calls
(``torch.cuda.max_memory_allocated`` above what was held before), and the
fraction of indices equal to ``current``'s on two inputs:

  the gate   the same inputs rounded to multiples of 1/8: every squared
             distance of every formulation is then exact in float32 (all
             terms are integers over 64, below 2^24 / 64), so the four agree
             index for index, ties taken by the first index as ``argmin``
             takes them, and a fraction below 1.0 is a fault of a
             formulation, not rounding;
  the timed  the unrounded inputs, where the matmul and the broadcast forms
             round differently: for the queries whose index differs, the
             largest gap between the two picks' squared distances, taken
             exactly (float64 on the original coordinates), says how near a
             tie each was.

Float32 with TF32 off.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rpeflow_tpu_torch.ops.knn import k_nearest_neighbor, squared_distance  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, sync  # noqa: E402

ITERS = 20
CHUNK = 4320


def current(inp, qry):
    return k_nearest_neighbor(inp, qry, 1)[..., 0]


def broadcast_full(inp, qry):
    diff = qry[:, :, None, :] - inp[:, None, :, :]
    return (diff * diff).sum(-1).argmin(-1)


def broadcast_chunked(inp, qry, chunk=CHUNK):
    return torch.cat([broadcast_full(inp, qry[:, q0:q0 + chunk])
                      for q0 in range(0, qry.shape[1], chunk)], dim=1)


def matmul_full(inp, qry):
    return squared_distance(qry, inp).argmin(-1)


VARIANTS = [("current (chunked matmul)", current), ("broadcast full", broadcast_full),
            ("broadcast chunked", broadcast_chunked), ("matmul full", matmul_full)]


def make_inputs(b, q, n, d, seed=0, grid=0):
    """The JAX script's points ``[B, N, D]`` and queries ``[B, Q, D]``
    (``rand * 100``), rounded to multiples of ``1 / grid`` unless it is 0."""
    rng = np.random.RandomState(seed)
    inp = rng.rand(b, n, d).astype(np.float32) * 100
    qry = rng.rand(b, q, d).astype(np.float32) * 100
    if grid:
        inp, qry = np.round(inp * grid) / grid, np.round(qry * grid) / grid
    return inp.astype(np.float32), qry.astype(np.float32)


def timed(fn, inp, qry, dev):
    """(ms a call over ITERS chained calls, peak device bytes or None)."""
    fn(inp, qry)
    sync(dev)
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    carry = torch.zeros((), device=dev)
    for _ in range(ITERS):
        out = fn(inp, qry + 0.0 * carry)
        carry = out.reshape(-1)[0].float()
    if dev.type == "cuda":
        end.record()
        out.reshape(-1)[0].item()  # the sync on the last output
        end.synchronize()
        return start.elapsed_time(end) / ITERS, torch.cuda.max_memory_allocated(dev) - base
    out.reshape(-1)[0].item()
    return (time.perf_counter() - t0) * 1e3 / ITERS, None


def matches(inp, qry):
    """Each variant's fraction of indices equal to ``current``'s."""
    ref = current(inp, qry)
    return {name: float((fn(inp, qry) == ref).float().mean()) for name, fn in VARIANTS}


def tie_gaps(inp, qry):
    """For each variant: the queries whose index differs from ``current``'s,
    and the largest |d^2(q, its pick) - d^2(q, current's pick)| over them,
    taken in float64 (0.0 where none differs)."""
    def exact_d2(idx):
        picked = torch.gather(inp.double(), 1, idx[..., None].expand(-1, -1, inp.shape[-1]))
        return ((qry.double() - picked) ** 2).sum(-1)

    ref = current(inp, qry)
    ref_d2 = exact_d2(ref)
    out = {}
    for name, fn in VARIANTS:
        idx = fn(inp, qry)
        off = idx != ref
        gap = (exact_d2(idx) - ref_d2).abs()[off]
        out[name] = {"mismatches": int(off.sum()),
                     "max_gap": float(gap.max()) if gap.numel() else 0.0}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--q", type=int, default=34560)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()
    on_card = dev.type == "cuda"
    shape = (args.b, args.q, args.n, args.d)
    gate = matches(*(torch.from_numpy(a).to(dev) for a in make_inputs(*shape, grid=8)))
    inp, qry = (torch.from_numpy(a).to(dev) for a in make_inputs(*shape))
    print(f"B={args.b} Q={args.q} N={args.n} D={args.d}, chunk {CHUNK}; "
          f"{'CUDA events' if on_card else 'host clock (CPU run)'}, {ITERS} chained calls",
          flush=True)
    raw = matches(inp, qry)
    gaps = tie_gaps(inp, qry)
    results = {}
    for name, fn in VARIANTS:
        ms, peak = timed(fn, inp, qry, dev)
        results[name] = {"ms": ms, "peak_gib": None if peak is None else peak / 2 ** 30,
                         "match": gate[name], "match_unrounded": raw[name], **gaps[name]}
        mem = "peak memory not measured (CPU run)" if peak is None else \
            f"peak memory {peak / 2 ** 30:.3f} GiB"
        print(f"{name:26s} {ms:9.3f} ms  {mem}  match vs current {gate[name]:.6f} "
              f"(1/8 grid), {raw[name]:.6f} (timed inputs; {gaps[name]['mismatches']} "
              f"differ, largest exact d^2 gap {gaps[name]['max_gap']:.3e})", flush=True)
    print(json.dumps({"knn1": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
