"""The benchmark's cells cut to a size the CPU runs in a second: 64x64
frames, 256 points, 2 decode levels, batch 2, a pool of 3. Every width and
the rest of the configuration are the cell's own; the limits are the cell's
calibrated ones."""

from __future__ import annotations

import copy

import torch

from benchmark import harness

CPU = torch.device("cpu")
SEED = 2**31 + 11


def tiny_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    config["n_samples"] = [128, 64]
    config["points"] = 256
    for mode in ("eval", "train"):
        config[mode].update(h=64, w=64)
    return config


def tiny_cell(name: str, root=harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(name, root)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, batch=2, pool=3, traced=1, sample=2,
                        warmup=3 if cell.train else 1)
    return cell


def run(cell, make_program=harness.Program, trace=False, seed=SEED, seconds=0.5):
    import time

    return harness.run(cell, seed, seconds, trace, CPU, time.perf_counter(),
                       make_program=make_program)
