"""Training driver (counterpart of rpeflow_tpu/train/trainer.py).

The epoch loop, per-step logging, validation with dataset-weighted means,
the best checkpoint by validation ``outlier2d`` and epoch-granular resume
follow the JAX trainer (and upstream train.py), and so do its summaries:
where ``tensorboardX`` imports, TensorBoard scalars ``train/<k>`` and
``train/lr`` at every step, ``val/<k>`` and the predicted-flow image
``val/flow_2d_pred`` of the first validation sample at every validation;
``log.profile_steps: [start, stop]`` records those steps of each epoch with
``torch.profiler`` into ``<log.dir>/profile``, the program's ``rpeflow.*``
spans included (:func:`..utils.profile.span`). Data comes from the port's
own host layer (``rpeflow_tpu_torch.data``, ``.factory``) when no batches
are given; reading a dataset needs h5py. A caller without it passes the
batch iterables itself (``train_batches``, ``val_batches``: each
iteration yields dicts of numpy arrays or tensors).

Under torchrun (``torchrun --nproc_per_node=N -m rpeflow_tpu_torch.train
--config ...``) every rank joins one process group
(:func:`..parallel.maybe_initialize_distributed`), runs on ``cuda:LOCAL_RANK``
and loads its contiguous slice of each global batch of ``model.batch_size``;
the steps then compute what one process computes on the global batch
(:mod:`.state`). Rank 0 alone logs, writes summaries, profiles and saves
checkpoints. With ``amp: true`` the two 2-D feature pyramids compute in
bfloat16, and nothing else (:class:`..model.RPEFlow`).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.loader import DataLoader, collate
from ..model import is_better
from ..parallel.mesh import (
    barrier,
    maybe_initialize_distributed,
    process_count,
    process_index,
    replicate,
)
from ..utils.profile import record_spans
from ..utils.visualization import flow_to_image
from .checkpoint import load_weights, restore_checkpoint, save_checkpoint
from .factory import dataset_factory, model_factory
from .optim import optimizer_factory
from .precision import use_f32
from . import graph
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
    batches are given; given batches are for one process)."""

    def __init__(self, cfgs, device="cuda", train_batches: Optional[Iterable] = None,
                 val_batches: Optional[Iterable] = None):
        use_f32()
        maybe_initialize_distributed(device)
        self.rank, self.world = process_index(), process_count()
        self.is_main = self.rank == 0
        self.cfgs = cfgs
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.curr_epoch = 1
        self.best_metrics: Optional[Dict[str, float]] = None
        self.log_dir = cfgs.log.dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.summary_writer = None
        if self.is_main:
            init_logging(os.path.join(self.log_dir, "train.log"))
            try:
                from tensorboardX import SummaryWriter

                self.summary_writer = SummaryWriter(self.log_dir)
            except ImportError:
                pass
        else:  # the other ranks stay silent
            logging.getLogger().handlers = [logging.NullHandler()]
        if cfgs.model.batch_size % self.world:
            raise ValueError(f"batch size {cfgs.model.batch_size} does not divide over "
                             f"{self.world} ranks")
        logging.info("Data parallel over %d rank(s), %d samples each, on %s", self.world,
                     cfgs.model.batch_size // self.world, self.device)

        if train_batches is None:
            train_batches, val_batches = self._loaders()
        elif self.world > 1:
            raise ValueError("with more than one rank the trainer reads its own loaders")
        self.train_batches = train_batches
        self.val_batches = val_batches if val_batches is not None else []

        amp = bool(getattr(cfgs, "amp", False))
        if amp:
            logging.info("amp: the 2-D feature pyramids compute in bfloat16")
        torch.manual_seed(int(getattr(cfgs, "seed", 0)))
        self.model = model_factory(cfgs.model, amp=amp)
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
        replicate(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(getattr(cfgs, "seed", 0)))

    def _loaders(self):
        cfgs = self.cfgs
        batch_size = cfgs.model.batch_size
        shard = dict(shard_index=self.rank, num_shards=self.world)
        trainset_cfg = cfgs.trainset if "trainset" in cfgs else cfgs.trainset1
        logging.info("Loading training set from %s", trainset_cfg.root_dir)
        train_set = dataset_factory(cfgs if "trainset1" in cfgs else cfgs.trainset)
        drop_last = bool(getattr(trainset_cfg, "drop_last", False))
        if self.world > 1 and not drop_last and len(train_set) % batch_size:
            raise ValueError(f"{len(train_set)} training samples end in a short batch, which "
                             f"{self.world} ranks cannot share evenly: set drop_last: true")
        train_loader = DataLoader(
            train_set, batch_size, shuffle=True, drop_last=drop_last,
            num_workers=int(getattr(trainset_cfg, "n_workers", 2)),
            use_process_pool=getattr(trainset_cfg, "use_process_pool", None), **shard)
        logging.info("Loading validation set from %s", cfgs.valset.root_dir)
        val_set = dataset_factory(cfgs.valset)
        val_loader = DataLoader(
            val_set, batch_size, shuffle=False,
            num_workers=int(getattr(cfgs.valset, "n_workers", 2)),
            use_process_pool=getattr(cfgs.valset, "use_process_pool", None), **shard)
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
            if self.summary_writer is not None:
                self.summary_writer.flush()
            self.curr_epoch += 1

    def _profiler(self) -> torch.profiler.profile:
        """A ``torch.profiler`` trace of the ``log.profile_steps`` window,
        written to ``<log.dir>/profile`` when stopped."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts, on_trace_ready=(
            torch.profiler.tensorboard_trace_handler(os.path.join(self.log_dir, "profile"))))

    def train_one_epoch(self) -> None:
        logging.info("Epoch %d: training...", self.curr_epoch)
        self.model.train()
        profile_steps = getattr(self.cfgs.log, "profile_steps", None)
        prof = None
        t_end = time.time()
        for i, batch in enumerate(self.train_batches):
            if profile_steps and self.is_main and i == int(profile_steps[0]):
                prof = self._profiler()
                prof.start()
                record_spans(True)
            if prof is not None and i == int(profile_steps[1]):
                record_spans(False)
                prof.stop()
                prof = None
            t_data = time.time() - t_end
            summary = train_step(self.model, self.optimizer, to_device(batch, self.device),
                                 self.generator)
            t_total = time.time() - t_end
            t_end = time.time()
            step, lr = self.optimizer.step_count, self.optimizer.lr
            logging.info("E%d S%d [%d/%d] %s, lr: %.2e, time: %.2fs (data %.2fs)",
                         self.curr_epoch, step, i + 1, self.steps_per_epoch,
                         log_string(summary), lr, t_total, t_data)
            if self.summary_writer is not None:
                for k, v in summary.items():
                    self.summary_writer.add_scalar(f"train/{k}", v, step)
                self.summary_writer.add_scalar("train/lr", lr, step)
        if prof is not None:  # the window reaches past the epoch's last step
            record_spans(False)
            prof.stop()
        logging.info("Epoch %d: train steps so far %s", self.curr_epoch, graph.STEPS)

    def _validation_batches(self):
        """``(global batch size, the batch this rank evaluates)`` for each
        validation batch. Over several ranks: the rank's slice of each full
        global batch, and a short last batch whole, on every rank (no slice
        is then empty, and the losses' global counts and the summary's mean
        over ranks give its global values all the same)."""
        if self.world == 1:
            for batch in self.val_batches:
                yield len(batch["images"]), batch
            return
        loader = self.val_batches
        n, bs = len(loader.dataset), loader.batch_size
        batches = iter(loader)
        try:
            for _ in range(n // bs):
                yield bs, next(batches)
        finally:
            batches.close()
        if n % bs:
            yield n % bs, collate([loader.dataset[i] for i in range(n - n % bs, n)])

    def validate(self) -> Dict[str, float]:
        """Dataset-weighted means of the per-batch summaries."""
        logging.info("Epoch %d: validating...", self.curr_epoch)
        sums: Dict[str, float] = {}
        n_total = 0
        step = self.optimizer.step_count
        for bi, (bs, batch) in enumerate(self._validation_batches()):
            tb = to_device(batch, self.device)
            outputs, summary = eval_step(self.model, tb)
            if bi == 0 and self.summary_writer is not None:
                # the predicted flow of the first validation sample
                img = flow_to_image(outputs["flow_2d"][0].cpu().numpy())
                self.summary_writer.add_image("val/flow_2d_pred", img, step, dataformats="HWC")
            for k, v in summary.items():
                sums[k] = sums.get(k, 0.0) + v * bs
            n_total += bs
        avg = {k: v / n_total for k, v in sums.items()}
        logging.info("Validation: %s", log_string(avg, with_mi=False))
        if self.summary_writer is not None:
            for k, v in avg.items():
                self.summary_writer.add_scalar(f"val/{k}", v, step)
        return avg

    def save_ckpt(self, name: str) -> str:
        """Rank 0 writes ``<log.dir>/<name>.pt``; every rank waits for it."""
        path = os.path.join(self.log_dir, f"{name}.pt")
        if self.is_main:
            save_checkpoint(path, self.model, self.optimizer, self.curr_epoch,
                            self.best_metrics)
        barrier()
        return path


def parser():
    """The train CLI's parser: the flags of the JAX ``train.py`` (``--port``
    accepted and ignored, as there), plus ``--device``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="conf/train/pretrain.yaml")
    ap.add_argument("--weights", default=None,
                    help="Initial weights (.pt; export a JAX orbax checkpoint with "
                         "scripts/export_torch_checkpoint.py)")
    ap.add_argument("--resume", action="store_true",
                    help="Resume epoch, step, optimizer and best metrics from --weights")
    ap.add_argument("--port", default=None,
                    help="Unused; kept for the reference command line")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", nargs="*", default=[],
                    help="Dotted config overrides, e.g. training.max_epochs=10")
    return ap


def main(argv=None) -> None:
    """Command line of ``python -m rpeflow_tpu_torch.train`` (:func:`parser`),
    and of ``torchrun --nproc_per_node=N -m rpeflow_tpu_torch.train`` over N
    GPUs."""
    args = parser().parse_args(argv)

    from .config import load_config

    cfgs = load_config(args.config, args.overrides)
    if args.weights is not None:
        cfgs.ckpt.path = args.weights
        cfgs.ckpt.resume = args.resume
    trainer = Trainer(cfgs, device=args.device)
    trainer.run()
    if trainer.summary_writer is not None:
        trainer.summary_writer.close()
