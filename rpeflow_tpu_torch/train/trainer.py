"""Training driver on one device (counterpart of rpeflow_tpu/train/trainer.py).

The epoch loop, per-step logging, validation with dataset-weighted means,
the best checkpoint by validation ``outlier2d`` and epoch-granular resume
follow the JAX trainer (and upstream train.py). Data comes from the shared
host layer (``rpeflow_tpu.data``, ``rpeflow_tpu.train.factory``), imported
only when no batches are given: it needs h5py and cv2. A caller without them
passes the batch iterables itself (``train_batches``, ``val_batches``: each
iteration yields dicts of numpy arrays or tensors).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..model import DEFAULT_N_SAMPLES, RPEFlow, is_better
from .checkpoint import load_weights, restore_checkpoint, save_checkpoint
from .optim import optimizer_factory
from .state import eval_step, train_step

BATCH_KEYS = ("images", "pcs", "event_voxel", "intrinsics", "flow_2d", "flow_3d")


def init_logging(log_file: Optional[str] = None) -> None:
    handlers = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
                        handlers=handlers, force=True)


def log_string(summary: Dict[str, float], with_mi: bool = True) -> str:
    """Per-step log line (reference RPEFlow.py:171-183)."""
    parts = ["loss: %.1f" % summary["loss"], "epe2d: %.3f" % summary["epe2d"],
             "epe3d: %.3f" % summary["epe3d"], "loss_2d: %.3f" % summary["loss_2d"],
             "loss_3d: %.3f" % summary["loss_3d"]]
    if with_mi and "mi_loss" in summary:
        parts.append("mi: %.3f" % summary["mi_loss"])
    return ", ".join(parts)


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items() if k in BATCH_KEYS}


class Trainer:
    """``cfgs`` is the training config (``model``, ``training``, ``log``,
    ``ckpt``, and ``trainset``/``trainset1..3``, ``valset`` unless the
    batches are given)."""

    def __init__(self, cfgs, device="cuda", train_batches: Optional[Iterable] = None,
                 val_batches: Optional[Iterable] = None):
        self.cfgs = cfgs
        self.device = torch.device(device)
        self.curr_epoch = 1
        self.best_metrics: Optional[Dict[str, float]] = None
        self.log_dir = cfgs.log.dir
        os.makedirs(self.log_dir, exist_ok=True)
        init_logging(os.path.join(self.log_dir, "train.log"))

        if train_batches is None:
            train_batches, val_batches = self._loaders()
        self.train_batches = train_batches
        self.val_batches = val_batches if val_batches is not None else []

        if cfgs.model.name != "RPEFlow":
            raise NotImplementedError(f"Unknown model name: {cfgs.model.name}")
        if getattr(cfgs, "amp", False):
            raise NotImplementedError("amp (bf16 autocast) is not ported; the port trains in f32")
        torch.manual_seed(int(getattr(cfgs, "seed", 0)))
        self.model = RPEFlow(cfgs.model, tuple(getattr(cfgs.model, "n_samples",
                                                       DEFAULT_N_SAMPLES)))
        logging.info("Trainable parameters: %d",
                     sum(p.numel() for p in self.model.parameters()))
        if cfgs.ckpt.path and not cfgs.ckpt.resume:
            logging.info("Transferring weights from %s (non-strict)", cfgs.ckpt.path)
            load_weights(cfgs.ckpt.path, self.model)
        self.model.to(self.device)

        self.steps_per_epoch = len(self.train_batches)
        self.optimizer = optimizer_factory(cfgs.training, self.model, self.steps_per_epoch)
        if cfgs.ckpt.path and cfgs.ckpt.resume:
            logging.info("Resuming from %s", cfgs.ckpt.path)
            meta = restore_checkpoint(cfgs.ckpt.path, self.model, self.optimizer)
            self.curr_epoch = int(meta["last_epoch"]) + 1
            self.best_metrics = meta["best_metrics"]
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(getattr(cfgs, "seed", 0)))

    def _loaders(self):
        from rpeflow_tpu.data.loader import DataLoader
        from rpeflow_tpu.train.factory import dataset_factory

        cfgs = self.cfgs
        batch_size = cfgs.model.batch_size
        trainset_cfg = cfgs.trainset if "trainset" in cfgs else cfgs.trainset1
        logging.info("Loading training set from %s", trainset_cfg.root_dir)
        train_set = dataset_factory(cfgs if "trainset1" in cfgs else cfgs.trainset)
        train_loader = DataLoader(
            train_set, batch_size, shuffle=True,
            drop_last=bool(getattr(trainset_cfg, "drop_last", False)),
            num_workers=int(getattr(trainset_cfg, "n_workers", 2)),
            use_process_pool=getattr(trainset_cfg, "use_process_pool", None))
        logging.info("Loading validation set from %s", cfgs.valset.root_dir)
        val_set = dataset_factory(cfgs.valset)
        val_loader = DataLoader(
            val_set, batch_size, shuffle=False,
            num_workers=int(getattr(cfgs.valset, "n_workers", 2)),
            use_process_pool=getattr(cfgs.valset, "use_process_pool", None))
        return train_loader, (val_loader if len(val_set) else [])

    def run(self) -> None:
        while self.curr_epoch <= self.cfgs.training.max_epochs:
            if hasattr(self.train_batches, "set_epoch"):
                self.train_batches.set_epoch(self.curr_epoch)
            self.train_one_epoch()
            if len(self.val_batches):
                val_summary = self.validate()
                if is_better(val_summary, self.best_metrics):
                    self.best_metrics = val_summary
                    logging.info("New best: outlier2d=%.4f", val_summary["outlier2d"])
                    if self.cfgs.log.save_ckpt:
                        self.save_ckpt("best")
            if (self.cfgs.log.save_ckpt
                    and self.curr_epoch % self.cfgs.log.save_ckpt_every_n_epochs == 0):
                self.save_ckpt("epoch-%03d" % self.curr_epoch)
            self.curr_epoch += 1

    def train_one_epoch(self) -> None:
        logging.info("Epoch %d: training...", self.curr_epoch)
        self.model.train()
        t_end = time.time()
        for i, batch in enumerate(self.train_batches):
            t_data = time.time() - t_end
            summary = train_step(self.model, self.optimizer, to_device(batch, self.device),
                                 self.generator)
            t_total = time.time() - t_end
            t_end = time.time()
            logging.info("E%d S%d [%d/%d] %s, lr: %.2e, time: %.2fs (data %.2fs)",
                         self.curr_epoch, self.optimizer.step_count, i + 1,
                         self.steps_per_epoch, log_string(summary), self.optimizer.lr,
                         t_total, t_data)

    def validate(self) -> Dict[str, float]:
        """Dataset-weighted means of the per-batch summaries."""
        logging.info("Epoch %d: validating...", self.curr_epoch)
        sums: Dict[str, float] = {}
        n_total = 0
        for batch in self.val_batches:
            tb = to_device(batch, self.device)
            bs = tb["images"].shape[0]
            _, summary = eval_step(self.model, tb)
            for k, v in summary.items():
                sums[k] = sums.get(k, 0.0) + v * bs
            n_total += bs
        avg = {k: v / n_total for k, v in sums.items()}
        logging.info("Validation: %s", log_string(avg, with_mi=False))
        return avg

    def save_ckpt(self, name: str) -> str:
        path = os.path.join(self.log_dir, f"{name}.pt")
        save_checkpoint(path, self.model, self.optimizer, self.curr_epoch, self.best_metrics)
        return path


def main(argv=None) -> None:
    """Command line of ``python -m rpeflow_tpu_torch.train`` (the flags of
    the JAX ``train.py``, plus ``--device``)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="conf/train/pretrain.yaml")
    parser.add_argument("--weights", default=None, help="Initial weights (.pt)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume epoch, step, optimizer and best metrics from --weights")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--overrides", nargs="*", default=[],
                        help="Dotted config overrides, e.g. training.max_epochs=10")
    args = parser.parse_args(argv)

    from rpeflow_tpu.train.config import load_config

    cfgs = load_config(args.config, args.overrides)
    if args.weights is not None:
        cfgs.ckpt.path = args.weights
        cfgs.ckpt.resume = args.resume
    Trainer(cfgs, device=args.device).run()
