"""Training checkpoints (counterpart of rpeflow_tpu/train/checkpoint.py).

One ``torch.save`` file per checkpoint with the reference's schema,
``{last_epoch, last_step, state_dict, best_metrics}``, plus the optimizer's
state under ``optimizer``. ``compat.load_checkpoint`` reads the same file
strictly into the eval model.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from .optim import Optimizer


def save_checkpoint(path: str, model: nn.Module, optimizer: Optional[Optimizer],
                    last_epoch: int, best_metrics: Optional[Dict[str, float]]) -> None:
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "last_epoch": int(last_epoch),
        "last_step": optimizer.step_count if optimizer is not None else -1,
        "state_dict": model.state_dict(),
        "best_metrics": None if best_metrics is None else
        {k: float(v) for k, v in best_metrics.items()},
    }
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    logging.info("saved checkpoint %s (epoch %d)", path, last_epoch)


def restore_checkpoint(path: str, model: nn.Module, optimizer: Optional[Optimizer]) -> Dict:
    """Load weights (strictly) and the optimizer state for a resume; returns
    ``{last_epoch, last_step, best_metrics}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    if optimizer is not None and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return {k: ckpt.get(k) for k in ("last_epoch", "last_step", "best_metrics")}


def load_weights(path: str, model: nn.Module) -> list:
    """Non-strict transfer (pretrain -> fine-tune): copy every entry whose
    name and shape match; returns the names left as they were."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    source = ckpt.get("state_dict", ckpt)
    source = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in source.items()}
    target = model.state_dict()
    matched = {k: v for k, v in source.items()
               if k in target and tuple(v.shape) == tuple(target[k].shape)}
    model.load_state_dict(matched, strict=False)
    skipped = sorted(set(target) - set(matched))
    if skipped:
        logging.info("load_weights: %d entries not in the checkpoint (non-strict transfer)",
                     len(skipped))
    return skipped
