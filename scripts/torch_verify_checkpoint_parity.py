#!/usr/bin/env python3
"""Checkpoint parity against the reference README tables, through the
port (the counterpart of scripts/verify_checkpoint_parity.py).

    python scripts/torch_verify_checkpoint_parity.py \\
        --weights RPEFlow_things.pt \\
        --data-root /data/FlyingThings3D_subset_pc \\
        [--config conf/test/things.yaml] [--benchmark things] \\
        [--max-batches 50] [--n-resample 4] [--device cuda]

The released checkpoints reproducing the README metric tables are the
reference's integration test. This script loads a released upstream
``.pt`` strictly into the port's model (``compat.load_checkpoint``, through
the port's ``Evaluator``), evaluates the benchmark's test set, and holds
every metric to the published row: the same rows, tolerances, flags and
JSON report as the JAX script, exit code 1 on a failure. Benchmarks: things
and ekubric (with the non-occluded block), dsec (without).

Tolerances (defaults; ``--rel-tol-epe2d``, ``--rel-tol-epe3d``,
``--abs-tol-pct``): the fixed-``n_points`` resample of the variable-size
clouds spreads the 3-D metrics by a few percent per draw, which
``--n-resample 4`` averages down; 2-D metrics have no resample dependence
and get the tight bound; accuracy percentages compare in absolute points.
A ``--max-batches`` subset widens the sampling noise: the binding proof is
the full set. Neither the released checkpoints nor the datasets are in the
repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Published rows (reference README.md:104-116, 126-138, 148-156; mirrored
# in BASELINE.md), as in scripts/verify_checkpoint_parity.py.
EXPECTED = {
    "things": {
        "with_occ": True,
        "config": "conf/test/things.yaml",
        "metrics": {
            "EPE2d": 1.402, "1px": 86.22, "Fl": 5.75,
            "EPE3d": 0.042, "5cm": 88.00, "10cm": 93.08,
            "EPE3d_noc": 0.024, "5cm_noc": 93.14, "10cm_noc": 96.72,
        },
    },
    "ekubric": {
        "with_occ": True,
        "config": "conf/test/ekubric.yaml",
        "metrics": {
            "EPE2d": 0.439, "1px": 95.99, "Fl": 1.48,
            "EPE3d": 0.027, "5cm": 95.33, "10cm": 96.32,
            "EPE3d_noc": 0.007, "5cm_noc": 98.66, "10cm_noc": 99.19,
        },
    },
    "dsec": {
        "with_occ": False,
        "config": "conf/test/dsec.yaml",
        "metrics": {
            "EPE2d": 0.326, "1px": 95.28, "Fl": 1.15,
            "EPE3d": 0.103, "5cm": 60.81, "10cm": 74.97,
        },
    },
}

EPE_2D_REL_TOL = 0.05
EPE_3D_REL_TOL = 0.15
PCT_ABS_TOL = 2.0


class _LimitedLoader:
    """The first ``n`` batches of a loader (subset dry runs)."""

    def __init__(self, loader, n: int):
        self._loader = loader
        self._n = n
        self.batch_size = loader.batch_size
        self.local_batch = loader.local_batch

    def __len__(self):
        return min(self._n, len(self._loader))

    def __iter__(self):
        batches = iter(self._loader)
        try:
            for _ in range(len(self)):
                yield next(batches)
        finally:
            batches.close()


def compare(results, spec, args):
    """(report, failures) of ``results`` against the benchmark's row."""
    rel_epe = {"EPE2d": args.rel_tol_epe2d, "EPE3d": args.rel_tol_epe3d,
               "EPE3d_noc": args.rel_tol_epe3d}
    failures, report = [], {}
    for name, expected in spec["metrics"].items():
        got = results.get(name)
        if got is None or math.isnan(got):
            failures.append(f"{name}: missing/NaN (expected {expected})")
            report[name] = {"expected": expected, "got": got, "ok": False}
            continue
        tol = rel_epe[name] * expected if name in rel_epe else args.abs_tol_pct
        ok = abs(got - expected) <= tol
        report[name] = {"expected": expected, "got": round(got, 4), "tol": round(tol, 4),
                        "ok": ok}
        if not ok:
            failures.append(f"{name}: got {got:.4f}, expected {expected} (+/- {tol:.4f})")
    return report, failures


def run(args) -> int:
    from rpeflow_tpu_torch.train.config import load_config
    from rpeflow_tpu_torch.train.evaluator import Evaluator
    from rpeflow_tpu_torch.train.trainer import init_logging
    from rpeflow_tpu_torch.utils.timing import resolve_device

    spec = EXPECTED[args.benchmark]
    cfgs = load_config(args.config or os.path.join(REPO, spec["config"]))
    cfgs.ckpt.path = args.weights
    cfgs.ckpt.strict = True
    if args.data_root:
        cfgs.testset.root_dir = args.data_root
    if args.n_resample:
        cfgs.testset.set_dotted("n_resample", str(args.n_resample))
    if args.batch_size:
        cfgs.model.set_dotted("batch_size", str(args.batch_size))

    init_logging()
    evaluator = Evaluator(cfgs, with_occ=spec["with_occ"], device=resolve_device(args.device))
    if args.max_batches:
        evaluator.loader = _LimitedLoader(evaluator.loader, args.max_batches)
    results = evaluator.run()
    report, failures = compare(results, spec, args)
    print(json.dumps({
        "benchmark": args.benchmark,
        "weights": args.weights,
        "device": args.device,
        "max_batches": args.max_batches,
        "n_resample": args.n_resample,
        "metrics": report,
        "pass": not failures,
    }, indent=2))
    if failures:
        print("PARITY FAIL:", file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print("PARITY PASS", file=sys.stderr)
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", required=True, help="upstream .pt checkpoint")
    p.add_argument("--benchmark", choices=sorted(EXPECTED), default="things")
    p.add_argument("--config", default=None,
                   help="override the benchmark's default conf/test YAML")
    p.add_argument("--data-root", default=None,
                   help="dataset root (overrides testset.root_dir)")
    p.add_argument("--max-batches", type=int, default=0,
                   help="evaluate only the first N batches (dry runs; "
                        "0 = full test set, the binding proof)")
    p.add_argument("--n-resample", type=int, default=4,
                   help="seeded resample rounds averaged (0 = config value)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override model.batch_size (0 = config value)")
    p.add_argument("--rel-tol-epe2d", type=float, default=EPE_2D_REL_TOL)
    p.add_argument("--rel-tol-epe3d", type=float, default=EPE_3D_REL_TOL)
    p.add_argument("--abs-tol-pct", type=float, default=PCT_ABS_TOL)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
