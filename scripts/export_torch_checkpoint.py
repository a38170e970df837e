#!/usr/bin/env python
"""Export a checkpoint of the JAX trainer (an orbax directory) to the
PyTorch port's ``.pt`` checkpoint file.

    python scripts/export_torch_checkpoint.py --ckpt logs/run/best --out best.pt

The orbax directory is read as ``rpeflow_tpu/train/checkpoint.py :
load_weights`` reads it: a structure-free ``StandardCheckpointer().restore``,
of which the model variables (``params``, ``batch_stats``) are kept, plus
``<dir>.meta.json`` (epoch, step, best metrics) where it exists. The
variables are renamed to the upstream torch ``state_dict`` names by
``rpeflow_tpu.compat.torch_loader.to_torch_state_dict`` and written with
``torch.save`` in the schema of ``rpeflow_tpu_torch/train/checkpoint.py``:
``{last_epoch, last_step, state_dict, best_metrics}``. The file holds
weights only, no optimizer state: fine-tuning from it starts a fresh Adam
(``--weights``, without ``--resume``), and evaluation loads it strictly:

    python -m rpeflow_tpu_torch.eval_withocc --weights best.pt --config conf/test/things.yaml
    python -m rpeflow_tpu_torch.train --config conf/train/ekubric.yaml --weights best.pt

This script imports the JAX package (and orbax, which imports JAX); the
port itself reads no orbax directory. It runs on the host's CPU.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def read_orbax(path):
    """``(variables, meta)`` of an orbax checkpoint directory written by
    ``rpeflow_tpu.train.checkpoint.CheckpointManager.save``: the model
    variables (``params``, ``batch_stats``), and the sidecar's epoch, step and best
    metrics (the step from the checkpoint where there is no sidecar)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    restored = ocp.StandardCheckpointer().restore(path)
    tree = restored if "params" in restored else {"params": restored}
    variables = {k: tree[k] for k in ("params", "batch_stats") if tree.get(k)}
    meta = {"last_epoch": -1, "last_step": int(np.asarray(tree["step"])) if "step" in tree
            else -1, "best_metrics": None}
    if os.path.isfile(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta.update(json.load(f))
    return variables, meta


def export(ckpt, out):
    """Write ``out`` (the port's ``.pt`` schema) from the orbax directory
    ``ckpt``; returns the payload written."""
    import torch

    from rpeflow_tpu.compat.torch_loader import to_torch_state_dict

    variables, meta = read_orbax(ckpt)
    state = {k: torch.from_numpy(np.array(v)) for k, v in to_torch_state_dict(variables).items()}
    payload = {"last_epoch": int(meta["last_epoch"]), "last_step": int(meta["last_step"]),
               "state_dict": state, "best_metrics": meta["best_metrics"]}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(payload, out)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="orbax checkpoint directory of the JAX trainer")
    ap.add_argument("--out", required=True, help="the .pt file to write")
    args = ap.parse_args(argv)
    payload = export(args.ckpt, args.out)
    n = sum(t.numel() for t in payload["state_dict"].values())
    print(f"wrote {args.out}: {len(payload['state_dict'])} tensors, {n} elements, "
          f"epoch {payload['last_epoch']}, step {payload['last_step']}, "
          f"best metrics {payload['best_metrics']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
