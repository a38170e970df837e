"""FlyingThings3D-subset datasets (RGB + point cloud, with/without events).

Mirrors reference flyingthings3d.py:11-248 in channels-last layout:
preprocessed-HDF5 fast path (``<split>_preprocess_ev{bins}_{pol}/left``),
raw path (PNG flow / npz clouds / packbit occlusion masks / HDF5 event
streams), fast-motion masking (<250 px), joint augmentation, and train-time
random point subsampling.

Deviation from the reference: evaluation items are also resampled to
``n_points`` (deterministically, seed 0) when the stored cloud size differs —
TPU batches must be static-shape. Set ``n_points: null`` to disable.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .augmentation import joint_augmentation
from .dataset import Dataset
from .event_voxel import events_to_voxel, load_events_h5
from .io import load_flow_png

FT3D_INTRINSICS = (1050.0, 479.5, 269.5)


class FlyingThings3DEvent(Dataset):
    """RGB + point clouds + event voxel (reference flyingthings3d.py:113-248)."""

    with_events = True

    def __init__(self, cfgs):
        assert os.path.isdir(cfgs.root_dir), f"{cfgs.root_dir} not found"
        self.root_dir = str(cfgs.root_dir)
        self.split = str(cfgs.split)
        self.split_dir = os.path.join(self.root_dir, self.split)
        self.cfgs = cfgs

        if self.with_events:
            self.event_dir = os.path.join(self.root_dir,
                                          self.split + "_events_h5", "left")
            self.event_bins = cfgs.event_bins
            self.event_polarity = bool(cfgs.event_polarity)
            tag = f"_preprocess_ev{self.event_bins}_{int(self.event_polarity)}"
        else:
            tag = "_preprocess_ev10_1"
        self.preprocess_dir = os.path.join(self.root_dir, self.split + tag, "left")
        self.is_preprocess = os.path.isdir(self.preprocess_dir)

        self.indices = []
        if self.is_preprocess:
            for filename in os.listdir(self.preprocess_dir):
                self.indices.append(int(filename.split("_")[0]))
        else:
            for filename in os.listdir(os.path.join(self.split_dir, "flow_2d")):
                idx = filename.split(".")[0]
                if not self.with_events or os.path.isfile(
                        os.path.join(self.event_dir, idx + "_event.hdf5")):
                    self.indices.append(int(idx))
        self.indices.sort()

    def __len__(self):
        return len(self.indices)

    def _load_preprocessed(self, path):
        import h5py

        with h5py.File(path, "r") as f:
            out = {k: np.array(f[k]) for k in f.keys()}
        return out

    def _load_raw(self, idx1: int, idx2: int) -> Dict[str, np.ndarray]:
        import cv2

        pcs = np.load(os.path.join(self.split_dir, "pc", "%07d.npz" % idx1))
        pc1, pc2 = pcs["pc1"], pcs["pc2"]
        flow_2d, flow_mask_2d = load_flow_png(
            os.path.join(self.split_dir, "flow_2d", "%07d.png" % idx1))
        flow_3d = np.load(os.path.join(self.split_dir, "flow_3d", "%07d.npy" % idx1))
        occ = np.load(os.path.join(self.split_dir, "occ_mask_3d", "%07d.npy" % idx1))
        occ = np.unpackbits(occ, count=len(pc1))
        image1 = cv2.imread(
            os.path.join(self.split_dir, "image", "%07d.png" % idx1))[..., ::-1]
        image2 = cv2.imread(
            os.path.join(self.split_dir, "image", "%07d.png" % idx2))[..., ::-1]

        out = dict(image1=image1, image2=image2, flow_2d=flow_2d,
                   flow_mask_2d=flow_mask_2d, flow_3d=flow_3d,
                   occ_mask_3d=occ, pc1=pc1, pc2=pc2)
        if self.with_events:
            h, w = image1.shape[:2]
            events = load_events_h5(
                os.path.join(self.event_dir, "%07d_event.hdf5" % idx1))
            out["event_voxel"] = events_to_voxel(
                events, self.event_bins, h, w, self.event_polarity)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not self.cfgs.augmentation.enabled:
            # resample_seed=0 keeps the historical deterministic draw;
            # the evaluator varies it for n_resample-averaged eval
            np.random.seed(self.resample_seed)

        idx1 = self.indices[i]
        f, cx, cy = FT3D_INTRINSICS

        pre_file = os.path.join(self.preprocess_dir,
                                "%07d_preprocessed.hdf5" % idx1)
        if self.is_preprocess and os.path.isfile(pre_file):
            d = self._load_preprocessed(pre_file)
        else:
            d = self._load_raw(idx1, idx1 + 1)

        image1, image2 = d["image1"], d["image2"]
        pc1, pc2 = d["pc1"].astype(np.float32), d["pc2"].astype(np.float32)
        flow_2d, flow_mask_2d = d["flow_2d"], d["flow_mask_2d"]
        flow_3d = d["flow_3d"].astype(np.float32)
        occ_mask_3d = d["occ_mask_3d"]
        event_voxel = d.get("event_voxel")

        # ignore fast-moving objects (reference flyingthings3d.py:82-83)
        flow_mask_2d = np.logical_and(
            flow_mask_2d, np.linalg.norm(flow_2d, axis=-1) < 250.0)
        flow_2d = np.concatenate(
            [flow_2d, flow_mask_2d[..., None].astype(np.float32)], axis=2)

        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event_voxel = \
            joint_augmentation(image1, image2, pc1, pc2, flow_2d, flow_3d,
                               f, cx, cy, self.cfgs.augmentation,
                               event=event_voxel)

        n_points = getattr(self.cfgs, "n_points", None)
        if n_points:
            resample = (self.split == "train") or pc1.shape[0] != n_points \
                or pc2.shape[0] != n_points
            if resample:
                idxs1 = np.random.choice(pc1.shape[0], n_points,
                                         replace=pc1.shape[0] < n_points)
                idxs2 = np.random.choice(pc2.shape[0], n_points,
                                         replace=pc2.shape[0] < n_points)
                pc1, flow_3d, occ_mask_3d = pc1[idxs1], flow_3d[idxs1], occ_mask_3d[idxs1]
                pc2 = pc2[idxs2]

        item = {
            "index": np.int32(idx1),
            "images": np.concatenate([image1, image2], axis=-1),
            "flow_2d": flow_2d.astype(np.float32),
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": flow_3d.astype(np.float32),
            "occ_mask_3d": occ_mask_3d.astype(np.float32),
            "intrinsics": np.float32([f, cx, cy]),
        }
        if event_voxel is not None:
            item["event_voxel"] = event_voxel.astype(np.float32)
        return item

    def get_image1_path(self, i: int) -> str:
        """Reference flyingthings3d.py:107-110 accessor."""
        return os.path.join(self.split_dir, "image", "%07d.png" % self.indices[i])

    def get_raw_events(self, i: int) -> np.ndarray:
        """Reference flyingthings3d.py:243-248 accessor."""
        assert self.with_events
        return load_events_h5(
            os.path.join(self.event_dir, "%07d_event.hdf5" % self.indices[i]))


class FlyingThings3D(FlyingThings3DEvent):
    """RGB + point clouds only (reference flyingthings3d.py:11-110)."""

    with_events = False
