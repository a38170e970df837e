"""Evaluation loop (counterpart of rpeflow_tpu/train/evaluator.py).

Dataset-level, pixel/point-count-weighted metrics: EPE / 1px / Fl for 2-D,
EPE / 5cm / 10cm for 3-D, and the non-occluded 3-D split when ``with_occ``.
The host data layer is the port's own copy of the JAX package's
(``rpeflow_tpu_torch.data``, ``.train.config``, ``.train.factory``); reading
a dataset needs h5py (and cv2 for raw files), so it is imported only by
:class:`Evaluator`, never by the model.

Under torchrun each rank evaluates its contiguous slice of every global
batch, and the metric sums are summed over the ranks batch by batch; a rank
whose slice of a short last batch is empty adds zeros (the forward, with
running batch-norm statistics, has no collective of its own).
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from ..compat import load_checkpoint
from ..parallel.mesh import all_reduce_, maybe_initialize_distributed, process_count, process_index
from ..utils.profile import span
from .precision import use_f32

MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
#: the keys of :func:`_metric_sums`, in its order
SUM_KEYS = ("2d/counts", "2d/EPE2d", "2d/1px", "2d/Fl", "3d/counts", "3d/EPE3d", "3d/5cm",
            "3d/10cm")
NOC_SUM_KEYS = ("3dnoc/counts", "3dnoc/EPE3d", "3dnoc/5cm", "3dnoc/10cm")


def _metric_sums(outputs, batch, with_occ: bool) -> Dict[str, torch.Tensor]:
    """Metric sums and counts for one batch (0-d tensors), in the profiler
    span ``rpeflow.eval.metric_sums``."""
    with span("rpeflow.eval.metric_sums"):
        pred2d = outputs["flow_2d"].float()
        pred3d = outputs["flow_3d"].float()
        t2d = batch["flow_2d"].float()
        t3d = batch["flow_3d"].float()
        if t2d.shape[-1] > 2:
            mask2d = t2d[..., 2] > 0
            t2d = t2d[..., :2]
        else:
            mask2d = torch.ones(t2d.shape[:3], dtype=torch.bool, device=t2d.device)
        if t3d.shape[-1] > 3:
            mask3d = t3d[..., 3] > 0
            t3d = t3d[..., :3]
        else:
            mask3d = torch.ones(t3d.shape[:2], dtype=torch.bool, device=t3d.device)

        epe2d = torch.linalg.norm(pred2d - t2d, dim=-1)
        epe3d = torch.linalg.norm(pred3d - t3d, dim=-1)
        mask2d = mask2d & ~torch.isnan(epe2d)
        mask3d = mask3d & ~torch.isnan(epe3d)
        m2 = mask2d.float()
        m3 = mask3d.float()
        mag = torch.linalg.norm(t2d, dim=-1)
        fl = ((epe2d > 3.0) & (epe2d / mag > 0.05)).float()
        zero = torch.zeros((), device=epe2d.device)
        out = {
            "2d/counts": m2.sum(),
            "2d/EPE2d": torch.where(mask2d, epe2d, zero).sum(),
            "2d/1px": ((epe2d < 1.0) * m2).sum(),
            "2d/Fl": (fl * m2).sum(),
            "3d/counts": m3.sum(),
            "3d/EPE3d": torch.where(mask3d, epe3d, zero).sum(),
            "3d/5cm": ((epe3d < 0.05) * m3).sum(),
            "3d/10cm": ((epe3d < 0.1) * m3).sum(),
        }
        if with_occ:
            noc = (batch["occ_mask_3d"] == 0) & mask3d
            mn = noc.float()
            out.update({
                "3dnoc/counts": mn.sum(),
                "3dnoc/EPE3d": torch.where(noc, epe3d, zero).sum(),
                "3dnoc/5cm": ((epe3d < 0.05) * mn).sum(),
                "3dnoc/10cm": ((epe3d < 0.1) * mn).sum(),
            })
        return out


def report(totals: Dict[str, float], times, with_occ: bool) -> Dict[str, float]:
    """Dataset metrics from summed counts, with the JAX evaluator's keys."""
    totals = dict(totals)
    for key in ("2d/counts", "3d/counts", "3dnoc/counts"):
        if key in totals and totals[key] == 0.0:
            logging.error("no valid elements for %s: metrics are NaN", key)
            totals[key] = float("nan")
    res = {
        "EPE2d": totals["2d/EPE2d"] / totals["2d/counts"],
        "1px": totals["2d/1px"] / totals["2d/counts"] * 100.0,
        "Fl": totals["2d/Fl"] / totals["2d/counts"] * 100.0,
        "EPE3d": totals["3d/EPE3d"] / totals["3d/counts"],
        "5cm": totals["3d/5cm"] / totals["3d/counts"] * 100.0,
        "10cm": totals["3d/10cm"] / totals["3d/counts"] * 100.0,
    }
    if with_occ and "3dnoc/counts" in totals:
        res["EPE3d_noc"] = totals["3dnoc/EPE3d"] / totals["3dnoc/counts"]
        res["5cm_noc"] = totals["3dnoc/5cm"] / totals["3dnoc/counts"] * 100.0
        res["10cm_noc"] = totals["3dnoc/10cm"] / totals["3dnoc/counts"] * 100.0
    res["mean_time"] = float(np.mean(times[1:] if len(times) > 1 else times))
    logging.info("#### Time ####\nTime: %.4f", res["mean_time"])
    logging.info("#### 2D Metrics ####\nEPE: %.3f\n1px: %.2f%%\nFl:  %.2f%%",
                 res["EPE2d"], res["1px"], res["Fl"])
    logging.info("#### 3D Metrics ####\nEPE: %.3f\n5cm: %.2f%%\n10cm: %.2f%%",
                 res["EPE3d"], res["5cm"], res["10cm"])
    if "EPE3d_noc" in res:
        logging.info("#### 3D Metrics (Non-occluded) ####\nEPE: %.3f\n5cm: %.2f%%\n"
                     "10cm: %.2f%%", res["EPE3d_noc"], res["5cm_noc"], res["10cm_noc"])
    return res


class Evaluator:
    """``with_occ=True`` mirrors eval_withocc.py, ``False`` eval_noocc.py.
    The model computes in float32 (no ``amp``), as the JAX evaluator's."""

    def __init__(self, cfgs, with_occ: bool = True, device: str | torch.device = "cuda"):
        from ..data.loader import DataLoader
        from .factory import dataset_factory, model_factory

        use_f32()
        maybe_initialize_distributed(device)
        self.rank, self.world = process_index(), process_count()
        self.cfgs = cfgs
        self.with_occ = with_occ
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if cfgs.model.batch_size % self.world:
            raise ValueError(f"batch size {cfgs.model.batch_size} does not divide over "
                             f"{self.world} ranks")
        logging.info("Loading test set from %s", cfgs.testset.root_dir)
        self.dataset = dataset_factory(cfgs.testset)
        self.loader = DataLoader(
            self.dataset, cfgs.model.batch_size, shuffle=False,
            num_workers=int(getattr(cfgs.testset, "n_workers", 2)),
            use_process_pool=getattr(cfgs.testset, "use_process_pool", None),
            shard_index=self.rank, num_shards=self.world)
        logging.info("Creating model: %s", cfgs.model.name)
        self.model = model_factory(cfgs.model)
        logging.info("Loading checkpoint from %s", cfgs.ckpt.path)
        load_checkpoint(self.model, cfgs.ckpt.path,
                        strict=bool(getattr(cfgs.ckpt, "strict", True)))
        self.model.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, float] | None:
        """The dataset's metrics (on rank 0; None on the other ranks)."""
        totals: Dict[str, float] = {}
        times = []
        n_resample = int(getattr(self.cfgs.testset, "n_resample", 1) or 1)
        for rnd in range(n_resample):
            if n_resample > 1:
                self.dataset.set_resample_seed(rnd)
                logging.info("resample round %d/%d (seed %d)", rnd + 1, n_resample, rnd)
            self._run_round(totals, times)
        if n_resample > 1:
            self.dataset.set_resample_seed(0)
        return report(totals, times, self.with_occ) if self.rank == 0 else None

    def _local_batches(self):
        """This rank's slice of each global batch, None where it is empty."""
        n, bs = len(self.dataset), self.loader.batch_size
        lo = self.rank * self.loader.local_batch
        batches = iter(self.loader)
        try:
            for i in range(len(self.loader)):
                yield next(batches) if min(bs, n - i * bs) > lo else None
        finally:
            batches.close()

    def _run_round(self, totals: Dict[str, float], times) -> None:
        keys = MODEL_KEYS + ("flow_2d", "flow_3d") + (("occ_mask_3d",) if self.with_occ else ())
        sum_keys = SUM_KEYS + (NOC_SUM_KEYS if self.with_occ else ())
        for i, batch in enumerate(self._local_batches()):
            vec = torch.zeros(len(sum_keys), device=self.device)
            if batch is not None:
                tb = {k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in keys}
                self._sync()
                start = time.perf_counter()
                with torch.inference_mode():
                    outputs = self.model({k: tb[k] for k in MODEL_KEYS})
                    sums = _metric_sums(outputs, tb, self.with_occ)
                vec = torch.stack([sums[k] for k in sum_keys])
                self._sync()
                times.append(time.perf_counter() - start)
            sums = dict(zip(sum_keys, all_reduce_(vec, "metric sums").tolist()))
            if sums["3d/counts"] and sums["3d/EPE3d"] / sums["3d/counts"] > 10.0:
                logging.warning("batch %d: mean EPE3D %.2f > 10: inputs may be degenerate",
                                i, sums["3d/EPE3d"] / sums["3d/counts"])
            for k, v in sums.items():
                totals[k] = totals.get(k, 0.0) + v


def main(argv, with_occ: bool, default_config: str) -> Dict[str, float] | None:
    """Command line of the ``eval_withocc`` / ``eval_noocc`` entry points."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True, help="Path to a .pt state_dict")
    parser.add_argument("--config", default=default_config)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .config import load_config

    cfgs = load_config(args.config)
    cfgs.ckpt.path = args.weights
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    evaluator = Evaluator(cfgs, with_occ=with_occ, device=args.device)
    if evaluator.rank:  # the other ranks stay silent
        logging.getLogger().setLevel(logging.ERROR)
    return evaluator.run()
