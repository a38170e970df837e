"""The readings that a cell's correctness limits are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... [--control 3] [--out FILE]

For each seed, on the card at the cell's own size: the program as a run
drives it (eval: the warm-up, then as many iterations as a run compares,
each compared; train: the first steps that a run compares), held to the
reference, as :mod:`benchmark.check` holds a run. On the first ``--control``
seeds also the control, the reference computed in TF32 (the nearest
precision below the configuration's float32) put in the program's place,
and, for a train cell, the fault of a step that leaves half of the batch out
(the reference on half of each batch); a state left unchanged reads 1 on
``change.gap`` and ``bn.gap`` by their definition. Prints one JSON line per
seed and, last, the largest reading of the program and the smallest of the
control and the fault for each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from . import check, harness

ROOT = Path(__file__).resolve().parents[1]


def program_numbers(cell, seed, dev) -> dict:
    sd = check.weights(cell, seed, dev)
    program = harness.Program(cell, sd, seed, dev)
    warm = cell.traffic["warmup"]
    if cell.train:
        readings = harness.first_steps(program, [check.batch(cell, seed, i, dev)
                                                 for i in range(warm)], sd)
        del program, sd
        gc.collect()
        torch.cuda.empty_cache()
        reference, _ = check.reference_train(cell, seed, dev, steps=warm)
        return check.train_numbers(readings, reference), reference
    for i in range(warm):
        program(check.batch(cell, seed, i, dev))
    idx = list(range(warm, warm + cell.traffic["sample"]))
    outs = [program(check.batch(cell, seed, i, dev)) for i in idx]
    del program, sd
    gc.collect()
    torch.cuda.empty_cache()
    reference, _ = check.reference_eval(cell, seed, idx, dev, judged=[f for f, _ in outs])
    return check.eval_numbers(outs, reference, check.sum_keys(cell.with_occ)), (idx, reference)


def control_numbers(cell, seed, dev, reference) -> dict:
    warm = cell.traffic["warmup"]
    out = {}
    if cell.train:
        with check.tf32(True):
            ctl, _ = check.reference_train(cell, seed, dev, steps=warm)
        out["control"] = check.train_numbers(ctl, reference)
        half, _ = check.reference_train(cell, seed, dev, steps=warm, half=True)
        out["half_batch"] = check.train_numbers(half, reference)
    else:
        idx, ref = reference
        with check.tf32(True):
            ctl, _ = check.reference_eval(cell, seed, idx, dev)
        half, _ = check.reference_eval(cell, seed, idx, dev, half=True)
        for kind, outs in (("control", ctl), ("half_batch", half)):
            # the reference's flows beside the reference's sums of these
            # outputs' own flows, which are their own sums (the same code)
            judged = [(rf, sums) for (rf, _), (_, sums) in zip(ref, outs)]
            out[kind] = check.eval_numbers(outs, judged, check.sum_keys(cell.with_occ))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="control and fault readings on the first this many seeds")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    lines, worst, least = [], {}, {}
    for k, seed in enumerate(args.seeds):
        numbers, reference = program_numbers(cell, seed, dev)
        line = {"workload": cell.name, "seed": seed, "program": numbers}
        if k < args.control:
            line.update(control_numbers(cell, seed, dev, reference))
        del reference
        gc.collect()
        torch.cuda.empty_cache()
        lines.append(line)
        print(json.dumps(line), flush=True)
        for name, v in numbers.items():
            worst[name] = max(worst.get(name, 0.0), v)
        for kind in ("control", "half_batch"):
            for name, v in line.get(kind, {}).items():
                least.setdefault(kind, {})[name] = min(least.get(kind, {}).get(name, v), v)
    summary = {"workload": cell.name, "seeds": len(args.seeds), "program_max": worst,
               "min": least, "card": torch.cuda.get_device_name(dev)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
