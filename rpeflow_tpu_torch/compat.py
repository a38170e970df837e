"""Weight bridge from the JAX package.

The port's modules carry the upstream torch ``state_dict`` names, so a JAX
variable tree, renamed by :func:`to_torch_state_dict` (numpy only; the
port's copy of ``rpeflow_tpu/compat/torch_loader.py : to_torch_state_dict``),
loads directly, as does an upstream ``.pt`` checkpoint
(:func:`load_checkpoint`). A checkpoint the JAX trainer wrote (an orbax
directory) is turned into such a file by ``scripts/export_torch_checkpoint.py``
first: the port reads no orbax directory.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def to_torch_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ``{'params', 'batch_stats'}`` variables -> upstream torch
    ``state_dict`` names and layouts (numpy values).

    Kernels ``[kh, kw, I, O]`` / ``[k, I, O]`` / ``[I, O]`` become
    ``weight`` ``[O, I, kh, kw]`` / ``[O, I, k]`` / ``[O, I]``; a module-list
    suffix ``_N`` becomes ``.N``; BatchNorm ``scale`` becomes ``weight`` and
    its statistics ``running_mean`` / ``running_var`` (plus a zero
    ``num_batches_tracked``); channel-LayerNorm parameters go under the
    upstream ``body`` wrapper.
    """
    flat = {}
    flat.update({("params",) + k: v
                 for k, v in _flatten(variables.get("params", {})).items()})
    flat.update({("stats",) + k: v
                 for k, v in _flatten(variables.get("batch_stats", {})).items()})

    out: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        kind, *comps, leaf = path
        comps = [re.sub(r"_(\d+)$", r".\1", c) for c in comps]
        name = ".".join(comps)
        # the RAFT mask head is an nn.Sequential of the wrapper upstream
        name = name.replace("convex_upsampler.up_mask_head_2d.layers.",
                            "up_mask_head_2d.")

        if kind == "stats":
            out[f"{name}.running_{leaf}" if leaf in ("mean", "var")
                else f"{name}.{leaf}"] = arr
            if leaf == "mean":  # torch BatchNorm also tracks a step counter
                out[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)
            continue

        parent = comps[-1] if comps else ""
        if leaf == "kernel":
            if arr.ndim == 4:
                out[f"{name}.weight"] = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 3:
                out[f"{name}.weight"] = arr.transpose(2, 1, 0)
            elif arr.ndim == 2:
                out[f"{name}.weight"] = arr.transpose(1, 0)
            else:
                raise ValueError(f"unhandled kernel rank at {name}: {arr.shape}")
        elif leaf == "scale":  # BatchNorm
            out[f"{name}.weight"] = arr
        elif leaf == "weight":  # channel LayerNorm ('body' wrapper upstream)
            out[f"{name}.body.weight"] = arr
        elif leaf == "bias":
            # LayerNorm biases live under the upstream 'body' wrapper; all
            # other biases (convs, BatchNorm 'norm_fn') map directly
            if parent in ("norm1x", "norm1y", "norm2"):
                out[f"{name}.body.bias"] = arr
            else:
                out[f"{name}.bias"] = arr
        elif leaf == "temperature":
            out[f"{name}.temperature"] = arr
        else:
            raise ValueError(f"unhandled param leaf at {name}: {leaf}")
    return out


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any], strict: bool = True):
    """Load a JAX ``{'params', 'batch_stats'}`` tree into ``model``.

    ``variables`` holds numpy arrays (or anything ``np.asarray`` takes). The
    RPEFlow model's tree maps onto this package's ``RPEFlow``; a submodule's
    tree (e.g. one ``CrossTransformerBlock``'s) onto its counterpart.
    Returns ``load_state_dict``'s result.
    """
    state = {k: torch.from_numpy(np.array(v)) for k, v in to_torch_state_dict(variables).items()}
    return model.load_state_dict(state, strict=strict)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """``torch.load`` of a checkpoint file onto the CPU. A directory (the JAX
    trainer's orbax checkpoint) raises ``ValueError`` naming the script that
    exports it to a ``.pt`` file."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX trainer?); the port "
            "reads torch.save files only: convert it with python "
            f"scripts/export_torch_checkpoint.py --ckpt {path} --out <file>.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(model: nn.Module, path: str, strict: bool = True):
    """Load an upstream-format ``.pt`` file: a bare state_dict or
    ``{'state_dict': ...}``, with any DDP ``module.`` prefix stripped."""
    ckpt = read_checkpoint(path)
    state = ckpt.get("state_dict", ckpt)
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    return model.load_state_dict(state, strict=strict)
