"""EKubric (Kubric + simulated events) dataset.

Mirrors reference kubricdata.py:14-285 in channels-last layout: sequence
train/val split by ``idx % 5``, preprocessed ``sf_preprocess`` HDF5 fast
path, and the full raw pipeline (metadata.json intrinsics, bidirectional-flow
occlusion, foreground masks, depth->cloud lifting through the warped depth,
event voxelization, depth/flow/NaN/Inf filtering, out-of-frame pc2 removal).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .augmentation import joint_augmentation
from .dataset import Dataset
from .event_voxel import events_to_voxel, load_events_h5
from .flow_utils import flow_warp_numpy, get_occu_mask_bidirection
from .io import depth2pc, load_flow_png, load_tiff, project_pc2image_np


class KubricData(Dataset):
    def __init__(self, cfgs):
        assert os.path.isdir(cfgs.root_dir), f"{cfgs.root_dir} not found"
        self.root_dir = str(cfgs.root_dir)
        self.split = str(cfgs.split)
        assert self.split in ("train", "full", "val")
        self.cfgs = cfgs

        self.is_event = hasattr(cfgs, "event_bins") and cfgs.event_bins is not None
        if self.is_event:
            self.event_dir = os.path.join(self.root_dir, "events_i50_c0.15")
            self.event_bins = cfgs.event_bins
            self.event_polarity = bool(cfgs.event_polarity)

        self.preprocess_dir = os.path.join(self.root_dir, "sf_preprocess")
        self.is_preprocess = os.path.isdir(self.preprocess_dir)
        ls_folder = self.preprocess_dir if self.is_preprocess \
            else os.path.join(self.root_dir, "rgba")

        seqnames = getattr(cfgs, "data_seq", None)
        seq_num = len(os.listdir(ls_folder))
        if self.split == "full":
            valid_seq = set(range(seq_num))
        elif self.split == "train":
            valid_seq = {i for i in range(seq_num) if i % 5 != 0}
        else:
            valid_seq = {i for i in range(seq_num) if i % 5 == 0}

        self.indices = []
        if seqnames is None:
            for seq_idx, seqname in enumerate(sorted(os.listdir(ls_folder))):
                if seq_idx not in valid_seq:
                    continue
                seq_path = os.path.join(ls_folder, seqname)
                files = sorted(os.listdir(seq_path))
                total = len(files) if self.is_preprocess else len(files) - 1
                for k in range(total):
                    fid = files[k].split(".")[0].split("_")[0]
                    self.indices.append((seqname, int(fid)))
        else:
            for seqname in seqnames:
                seq_path = os.path.join(ls_folder, seqname)
                assert os.path.isdir(seq_path)
                files = sorted(os.listdir(seq_path))
                for k in range(len(files) - 1):
                    fid = files[k].split(".")[0].split("_")[0]
                    self.indices.append((seqname, int(fid)))

    def __len__(self):
        return len(self.indices)

    def _load_preprocessed(self, path):
        import h5py

        with h5py.File(path, "r") as f:
            return {k: np.array(f[k]) for k in f.keys()}

    def _load_raw(self, seq: str, idx1: int, idx2: int) -> Dict[str, np.ndarray]:
        import cv2

        root = self.root_dir
        meta = json.load(open(os.path.join(root, "metadata", seq, "metadata.json")))
        width, height = meta["flags"]["resolution"]
        focal_length = meta["camera"]["focal_length"]
        sensor_width = meta["camera"]["sensor_width"]
        fx = focal_length / sensor_width * width
        f = fx
        cx, cy = width / 2.0, height / 2.0

        image1 = cv2.imread(os.path.join(root, "rgba", seq, f"{idx1:05d}.png"))[..., ::-1]
        image2 = cv2.imread(os.path.join(root, "rgba", seq, f"{idx2:05d}.png"))[..., ::-1]

        flow_2d, flow_2d_mask = load_flow_png(
            os.path.join(root, "forward_flow", seq, f"{idx1:05d}.png"))
        flow_2d_mask = np.logical_and(
            np.linalg.norm(flow_2d, axis=-1) < self.cfgs.max_flow, flow_2d_mask)
        flow_2d_backward, _ = load_flow_png(
            os.path.join(root, "backward_flow", seq, f"{idx2:05d}.png"))
        flow_2d_nooccmask = get_occu_mask_bidirection(flow_2d, flow_2d_backward) < 0.5

        fg1 = np.sum(cv2.imread(
            os.path.join(root, "segmentation", seq, f"{idx1:05d}.png")), axis=-1) != 0
        fg2 = np.sum(cv2.imread(
            os.path.join(root, "segmentation", seq, f"{idx2:05d}.png")), axis=-1) != 0

        depth1 = load_tiff(os.path.join(root, "depth", seq, f"{idx1:05d}.tiff"))
        depth2 = load_tiff(os.path.join(root, "depth", seq, f"{idx2:05d}.tiff"))
        depth12 = flow_warp_numpy(depth2[..., None], flow_2d, 0, "bilinear")[:, :, 0]
        fg12 = flow_warp_numpy(fg2[..., None].astype(np.float32), flow_2d, 0,
                               "bilinear")[:, :, 0]

        mask = np.logical_and(depth12 != 0, flow_2d_mask)
        mask = np.logical_and(mask, fg1)
        depth12 = depth12.copy()
        depth1 = depth1.copy()
        depth12[mask == 0] = 1e6
        depth1[mask == 0] = 1e6

        noocc = np.logical_and(mask, fg12)
        noocc = np.logical_and(noocc, flow_2d_nooccmask)

        pc1 = depth2pc(depth1, f, cx, cy)[mask]
        pc2 = depth2pc(depth12, f, cx, cy, flow_2d)[mask]
        out = dict(
            image1=image1, image2=image2, flow_2d=flow_2d,
            flow_2d_mask=flow_2d_mask, flow_3d=pc2 - pc1,
            nooccmask_2d=noocc, nooccmask_3d=noocc[mask],
            pc1=pc1, pc2=pc2,
            metadata=np.float32([fx, fx, cx, cy]),
        )
        if self.is_event:
            events = load_events_h5(
                os.path.join(self.event_dir, seq, f"{idx1:05d}_event.hdf5"))
            out["event_voxel"] = events_to_voxel(
                events, self.event_bins, height, width, self.event_polarity)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not self.cfgs.augmentation.enabled:
            np.random.seed(self.resample_seed)

        seq, idx1 = self.indices[i]
        pre_file = os.path.join(self.preprocess_dir, seq,
                                f"{idx1:05d}_preprocessed.hdf5")
        if self.is_preprocess and os.path.isfile(pre_file):
            d = self._load_preprocessed(pre_file)
            metadata = np.array(d["metadata"]).reshape(-1)
        else:
            d = self._load_raw(seq, idx1, idx1 + 1)
            metadata = d["metadata"]

        f, cx, cy = float(metadata[0]), float(metadata[2]), float(metadata[3])
        image1, image2 = d["image1"], d["image2"]
        flow_2d = d["flow_2d"].astype(np.float32)
        flow_3d = d["flow_3d"].astype(np.float32)
        pc1 = d["pc1"].astype(np.float32)
        pc2 = d["pc2"].astype(np.float32)
        nooccmask_2d = np.array(d["nooccmask_2d"])
        nooccmask_3d = np.array(d["nooccmask_3d"])
        event_voxel = d.get("event_voxel")

        # depth / flow-magnitude / NaN / Inf filtering (kubricdata.py:204-223)
        m1 = pc1[..., -1] < self.cfgs.max_depth
        m2 = pc2[..., -1] < self.cfgs.max_depth
        pc1, pc2, flow_3d = pc1[m1], pc2[m2], flow_3d[m1]
        nooccmask_3d = nooccmask_3d[m1]
        m1 = np.linalg.norm(flow_3d, axis=-1) < self.cfgs.max_3dflow
        pc1, flow_3d, nooccmask_3d = pc1[m1], flow_3d[m1], nooccmask_3d[m1]

        m1 = ~np.isnan(np.sum(pc1, -1) + np.sum(flow_3d, -1))
        m2 = ~np.isnan(np.sum(pc2, -1))
        pc1, pc2, flow_3d = pc1[m1], pc2[m2], flow_3d[m1]
        nooccmask_3d = nooccmask_3d[m1]
        m1 = ~np.isinf(np.sum(pc1, -1) + np.sum(flow_3d, -1))
        m2 = ~np.isinf(np.sum(pc2, -1))
        pc1, pc2, flow_3d = pc1[m1], pc2[m2], flow_3d[m1]
        nooccmask_3d = nooccmask_3d[m1]

        # remove out-of-frame pc2 to create occlusion (kubricdata.py:225-232)
        height, width = image1.shape[:2]
        xy2 = project_pc2image_np(pc2, height, width, f, cx, cy, clip=False)
        bmask = ((xy2[..., 0] >= 0) & (xy2[..., 0] < width)
                 & (xy2[..., 1] >= 0) & (xy2[..., 1] < height))
        pc2 = pc2[bmask]

        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event_voxel = \
            joint_augmentation(image1, image2, pc1, pc2, flow_2d, flow_3d,
                               f, cx, cy, self.cfgs.augmentation, event=event_voxel)

        n_points = self.cfgs.n_points
        i1 = np.random.choice(pc1.shape[0], n_points, replace=pc1.shape[0] < n_points)
        i2 = np.random.choice(pc2.shape[0], n_points, replace=pc2.shape[0] < n_points)
        pc1, flow_3d, nooccmask_3d = pc1[i1], flow_3d[i1], nooccmask_3d[i1]
        pc2 = pc2[i2]

        item = {
            "index": np.int32(idx1),
            "images": np.concatenate([image1, image2], axis=-1),
            "flow_2d": flow_2d.astype(np.float32),
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": flow_3d.astype(np.float32),
            "occ_mask_2d": np.asarray(nooccmask_2d, np.float32),
            "occ_mask_3d": 1.0 - np.asarray(nooccmask_3d, np.float32),
            "intrinsics": np.float32([f, cx, cy]),
        }
        if event_voxel is not None:
            item["event_voxel"] = event_voxel.astype(np.float32)
        return item

    def get_image1_path(self, i: int) -> str:
        """Reference kubricdata.py:273-278 accessor."""
        seq, idx1 = self.indices[i]
        return os.path.join(self.root_dir, "rgba", seq, f"{idx1:05d}.png")

    def get_raw_events(self, i: int) -> np.ndarray:
        """Reference kubricdata.py:280-285 accessor."""
        assert self.is_event
        seq, idx1 = self.indices[i]
        return load_events_h5(
            os.path.join(self.event_dir, seq, f"{idx1:05d}_event.hdf5"))
