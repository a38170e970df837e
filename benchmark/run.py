"""Run one cell of the benchmark on the card(s) of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, last on standard error, each number compared for
``correct`` beside its limit; the last line of standard output is the result
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``). Exits 2, printing no
result, without a CUDA card (or with fewer than the cell asks for), and 1
when the program cannot be imported or a run fails. Build and kernel caches
are kept in directories of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "benchmark_cache"


def _plain(obj):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout, set before torch loads
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from . import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found. There is no CPU fallback.", file=sys.stderr)
        return 2
    try:
        import rpeflow_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the program under test cannot be imported: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
