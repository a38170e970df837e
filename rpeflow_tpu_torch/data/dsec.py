"""DSEC driving dataset (real event camera + CFNet disparity clouds).

Mirrors reference dsec.py:25-842 in channels-last layout:

  * ``flow_16bit_to_float`` PNG codec (dsec.py:25-44)
  * ``EventSlicer`` — ms->index windowed reads from the HDF5 event streams;
    the reference's numba-jit linear scans (dsec.py:137-195) are replaced by
    ``np.searchsorted`` with identical index semantics
  * hard-coded TRAIN_SEQUENCE train/val split (dsec.py:207-226)
  * ``DSECTrain`` — timestamp-aligned image/flow/disparity/event lookup,
    event rectification, trilinear (x, y, t) voxelizer variant with signed
    2p-1 values (dsec.py:536-604), disparity->depth->cloud lifting, a
    write-on-first-read preprocess HDF5 cache, and
  * ``DSECPreprocessTrain`` — preprocessed-only listing (dsec.py:799-842).

Note: raw DSEC events.h5 files are blosc-compressed and need the
``hdf5plugin`` package; the preprocessed path has no such dependency.

The port's copy of ``rpeflow_tpu/data/dsec.py``: ``yaml``, ``cv2`` and
``h5py`` are imported inside the functions that use them, and the
trilinear voxelizer scatters in the native host library (:mod:`.native`,
built with g++ at first use), as the JAX package's does when its library
loads; the numpy version is :func:`events_to_voxel_trilinear_plain`.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Tuple

import numpy as np

from .augmentation import joint_augmentation
from .dataset import Dataset
from .flow_utils import flow_warp_numpy
from .io import depth2pc, project_pc2image_np
from . import native


def flow_16bit_to_float(flow_16bit: np.ndarray):
    """DSEC 16-bit flow PNG decoding (reference dsec.py:25-44)."""
    assert flow_16bit.dtype == np.uint16 and flow_16bit.ndim == 3
    h, w, c = flow_16bit.shape
    assert c == 3
    valid2d = flow_16bit[..., 2] == 1
    f = flow_16bit.astype("float")
    flow_map = np.zeros((h, w, 2))
    ys, xs = np.where(valid2d)
    flow_map[ys, xs, 0] = (f[ys, xs, 0] - 2 ** 15) / 128
    flow_map[ys, xs, 1] = (f[ys, xs, 1] - 2 ** 15) / 128
    return flow_map, valid2d


class EventSlicer:
    """Windowed reads from a DSEC event HDF5 (reference dsec.py:47-204)."""

    def __init__(self, h5f):
        self.h5f = h5f
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = int(h5f["t_offset"][()])
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    def get_events(self, t_start_us: int, t_end_us: int) -> Dict[str, np.ndarray] | None:
        assert t_start_us < t_end_us
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset

        t_start_ms = math.floor(t_start_us / 1000)
        t_end_ms = math.ceil(t_end_us / 1000)
        t_start_ms_idx = self._ms2idx(t_start_ms)
        t_end_ms_idx = self._ms2idx(t_end_ms)
        if t_start_ms_idx is None or t_end_ms_idx is None:
            return None

        t_cons = np.asarray(self.events["t"][t_start_ms_idx:t_end_ms_idx])
        # index semantics identical to the reference's jit scans:
        # t[idx_start] >= t_start, t[idx_end - 1] < t_end
        idx_start = int(np.searchsorted(t_cons, t_start_us, side="left"))
        idx_end = int(np.searchsorted(t_cons, t_end_us, side="left"))

        events = {"t": t_cons[idx_start:idx_end] + self.t_offset}
        lo = t_start_ms_idx + idx_start
        hi = t_start_ms_idx + idx_end
        for k in ("p", "x", "y"):
            events[k] = np.asarray(self.events[k][lo:hi])
        return events

    def _ms2idx(self, time_ms: int):
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return self.ms_to_idx[time_ms]

    def close(self):
        self.h5f.close()


TRAIN_SEQUENCE = {
    "thun_00_a": True,
    "zurich_city_01_a": False,
    "zurich_city_02_a": False,
    "zurich_city_02_c": True,
    "zurich_city_02_d": True,
    "zurich_city_02_e": True,
    "zurich_city_03_a": True,
    "zurich_city_05_a": True,
    "zurich_city_05_b": False,
    "zurich_city_06_a": True,
    "zurich_city_07_a": True,
    "zurich_city_08_a": True,
    "zurich_city_09_a": False,
    "zurich_city_10_a": True,
    "zurich_city_10_b": True,
    "zurich_city_11_a": False,
    "zurich_city_11_b": True,
    "zurich_city_11_c": True,
}


def events_to_voxel_trilinear(xs, ys, ts, ps, num_bins, height, width) -> np.ndarray:
    """Signed trilinear (x, y, t) voxelization (reference dsec.py:536-573).

    Values are 2p-1; coordinates are float (rectified) so events spread over
    the 8 surrounding (x, y, t) cells. Returns [num_bins, H, W]. The scatter
    runs in the native host library (:mod:`.native`), with the coordinates
    and the normalised time in float32, as the JAX package's native path;
    :func:`events_to_voxel_trilinear_plain` is the numpy version.
    """
    vox = np.zeros((num_bins, height, width), np.float32)
    if len(ts) == 0:
        return vox
    t_norm = (num_bins - 1) * (ts - ts[0]) / max(ts[-1] - ts[0], 1e-9)
    native.event_scatter_trilinear(vox, xs, ys, t_norm, 2.0 * ps - 1.0)
    return vox


def events_to_voxel_trilinear_plain(xs, ys, ts, ps, num_bins, height,
                                    width) -> np.ndarray:
    """:func:`events_to_voxel_trilinear` with ``np.add.at`` (the plain version)."""
    vox = np.zeros(num_bins * height * width, np.float32)
    if len(ts) == 0:
        return vox.reshape(num_bins, height, width)
    t_norm = (num_bins - 1) * (ts - ts[0]) / max(ts[-1] - ts[0], 1e-9)

    x0 = xs.astype(np.int32)
    y0 = ys.astype(np.int32)
    t0 = t_norm.astype(np.int32)
    value = 2.0 * ps - 1.0

    for xlim in (x0, x0 + 1):
        for ylim in (y0, y0 + 1):
            for tlim in (t0, t0 + 1):
                mask = ((xlim < width) & (xlim >= 0) & (ylim < height)
                        & (ylim >= 0) & (tlim >= 0) & (tlim < num_bins))
                w = (value * (1 - np.abs(xlim - xs)) * (1 - np.abs(ylim - ys))
                     * (1 - np.abs(tlim - t_norm))).astype(np.float32)
                idx = (height * width * tlim.astype(np.int64)
                       + width * ylim.astype(np.int64) + xlim.astype(np.int64))
                np.add.at(vox, idx[mask], w[mask])
    return vox.reshape(num_bins, height, width)


class DSECTrain(Dataset):
    def __init__(self, cfgs):
        assert os.path.isdir(cfgs.root_dir), f"{cfgs.root_dir} not found"
        assert cfgs.split in ("train", "val", "full")
        self.cfgs = cfgs
        self.root_dir = os.path.join(cfgs.root_dir, "train")
        self.split = cfgs.split
        self.isbi = cfgs.isbi
        self.data_seqs = getattr(cfgs, "data_seq", None)
        self.event_bins = cfgs.event_bins
        self.event_polarity = cfgs.event_polarity
        self.is_preprocess = cfgs.use_preprocess
        self.preprocess_root = self.root_dir + "_preprocess_pc"
        self.height, self.width = 480, 640

        self.left_image1_filenames = []
        self.left_image2_filenames = []
        self.forward_flow_ts = []
        self.forward_flow_filenames = []
        self.backward_flow_filenames = []
        self.disparity_filenames = []
        self.calibration_filenames = []
        self.event_filenames = []
        self.event_slices = {}
        self.event_rectifys = {}
        self.preprocess_list = []
        self.data_length = 0

        self.fetch_valids()
        if self.is_preprocess and not self.preprocess_list:
            raise RuntimeError(
                f"no valid preprocess data under {self.preprocess_root}")
        if not self.is_preprocess and self.data_length == 0:
            raise RuntimeError(f"no valid data under {self.root_dir}")

    # ------------------------------------------------------------------
    def _base_seqs(self, listing_root):
        if self.data_seqs in (None, "full", ["full"]):
            seqs = sorted(f for f in os.listdir(listing_root)
                          if os.path.isdir(os.path.join(listing_root, f)))
            if self.split == "train":
                seqs = [s for s in seqs if TRAIN_SEQUENCE.get(s) is True]
            elif self.split == "val":
                seqs = [s for s in seqs if TRAIN_SEQUENCE.get(s) is False]
            return seqs
        logging.info("using DSEC seqs %s", self.data_seqs)
        return [self.data_seqs] if isinstance(self.data_seqs, str) else self.data_seqs

    def fetch_valids(self):
        for seq_index, seq in enumerate(self._base_seqs(self.root_dir)):
            full_seq = os.path.join(self.root_dir, seq)
            assert os.path.isdir(os.path.join(full_seq, "flow"))
            if self.is_preprocess:
                os.makedirs(os.path.join(self.preprocess_root, seq), exist_ok=True)

            cam_yaml = os.path.join(full_seq, "calibration", "cam_to_cam.yaml")
            ff_folder = os.path.join(full_seq, "flow", "forward")
            ff_ts = np.genfromtxt(os.path.join(full_seq, "flow", "forward_timestamps.txt"),
                                  delimiter=",", dtype="int64")
            ff_names = sorted(os.listdir(ff_folder))
            bf_folder = os.path.join(full_seq, "flow", "backward")
            bf_ts = np.genfromtxt(os.path.join(full_seq, "flow", "backward_timestamps.txt"),
                                  delimiter=",", dtype="int64")
            bf_names = sorted(os.listdir(bf_folder))
            assert len(ff_names) == len(bf_names)

            disp_folder = os.path.join(full_seq, "disparity", "event")
            disp_names = sorted(f for f in os.listdir(disp_folder) if f.endswith(".png"))
            disp_names = [os.path.join(disp_folder, f) for f in disp_names]
            disp_ts = np.loadtxt(os.path.join(full_seq, "disparity", "timestamps.txt"),
                                 dtype="int64")

            img_folder = os.path.join(full_seq, "images", "left", "ev_inf")
            img_names = sorted(f for f in os.listdir(img_folder) if f.endswith(".png"))
            img_names = [os.path.join(img_folder, f) for f in img_names]
            image_ts = np.loadtxt(os.path.join(full_seq, "images", "timestamps.txt"),
                                  dtype="int64")

            ev_file = os.path.join(full_seq, "events", "left", "events.h5")
            ev_rect = os.path.join(full_seq, "events", "left", "rectify_map.h5")

            seq_length = len(ff_names) - 1 if self.isbi else len(ff_names)
            for index in range(seq_length):
                ts_single = ff_ts[index]
                if self.isbi:
                    bts = bf_ts[index + 1]
                    if bts[0] != ts_single[1] or bts[1] != ts_single[0]:
                        continue
                    self.backward_flow_filenames.append(
                        os.path.join(bf_folder, bf_names[index + 1]))
                self.forward_flow_ts.append(ts_single)
                self.forward_flow_filenames.append(
                    os.path.join(ff_folder, ff_names[index]))

                i1 = int(np.searchsorted(image_ts, ts_single[0], side="left"))
                i2 = int(np.searchsorted(image_ts, ts_single[1], side="left"))
                assert image_ts[i1] == ts_single[0] and image_ts[i2] == ts_single[1]
                self.left_image1_filenames.append(img_names[i1])
                self.left_image2_filenames.append(img_names[i2])

                d1 = int(np.searchsorted(disp_ts, ts_single[0], side="left"))
                d2 = int(np.searchsorted(disp_ts, ts_single[1], side="left"))
                assert disp_ts[d1] == ts_single[0] and disp_ts[d2] == ts_single[1]
                self.disparity_filenames.append([disp_names[d1], disp_names[d2]])
                self.event_filenames.append([seq_index, ev_file, ev_rect])
                self.calibration_filenames.append(cam_yaml)

                if self.is_preprocess:
                    image1_id = os.path.basename(img_names[i1])[:-4]
                    self.preprocess_list.append(os.path.join(
                        self.preprocess_root, seq, image1_id + ".hdf5"))

        self.data_length = len(self.forward_flow_ts)

    def __len__(self):
        return self.data_length

    # ------------------------------------------------------------------
    @staticmethod
    def load_flow(path: str):
        # cv2 with IMREAD_UNCHANGED: the only PNG16 reader guaranteed in
        # this image — imageio's default pillow plugin cannot decode
        # 3-channel 16-bit PNGs (PIL has no RGB;16 mode), which would
        # silently break the DSEC flow GT. cv2 returns BGR -> reverse to
        # the spec's [fx, fy, valid] channel order.
        import cv2

        flow16 = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert flow16 is not None, f"failed to read {path}"
        if flow16.ndim == 3:
            flow16 = flow16[..., ::-1]
        return flow_16bit_to_float(np.ascontiguousarray(flow16).astype(np.uint16))

    @staticmethod
    def load_disparity(path: str):
        import cv2

        disp16 = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert disp16 is not None, f"failed to read {path}"
        return disp16.astype(np.uint16) / 256.0

    @staticmethod
    def load_image(path: str):
        from PIL import Image

        return np.array(Image.open(path))

    def rectify_events(self, ev, rectify_map):
        assert rectify_map.shape == (self.height, self.width, 2)
        xy = rectify_map[ev["y"], ev["x"]]
        xr, yr = xy[:, 0], xy[:, 1]
        m = (xr >= 0) & (xr < self.width) & (yr >= 0) & (yr < self.height)
        return dict(x=xr[m], y=yr[m], p=ev["p"][m], t=ev["t"][m])

    def _slicer(self, event_names):
        import h5py

        seq_index = str(event_names[0])
        if seq_index not in self.event_slices:
            try:
                import hdf5plugin  # noqa: F401  (blosc codec registration)
            except ImportError:
                logging.warning("hdf5plugin unavailable; raw DSEC event reads "
                                "may fail on compressed files")
            event_file = h5py.File(event_names[1], "r")
            with h5py.File(event_names[2], "r") as h5_rect:
                self.event_rectifys[seq_index] = h5_rect["rectify_map"][()]
            self.event_slices[seq_index] = EventSlicer(event_file)
        return self.event_slices[seq_index], self.event_rectifys[seq_index]

    def load_rectifyed_events(self, event_names, start_ts, end_ts):
        slicer, rect = self._slicer(event_names)
        return self.rectify_events(slicer.get_events(start_ts, end_ts), rect)

    def get_item_events(self, index, rectifyed=True):
        event_names = self.event_filenames[index]
        start_ts, end_ts = self.forward_flow_ts[index]
        if rectifyed:
            return self.load_rectifyed_events(event_names, start_ts, end_ts)
        slicer, _ = self._slicer(event_names)
        return slicer.get_events(start_ts, end_ts)

    def load_data_by_index(self, index):
        start_ts, end_ts = self.forward_flow_ts[index]
        im1 = self.load_image(self.left_image1_filenames[index])
        im2 = self.load_image(self.left_image2_filenames[index])
        disp1 = self.load_disparity(self.disparity_filenames[index][0])
        disp2 = self.load_disparity(self.disparity_filenames[index][1])
        events = self.load_rectifyed_events(
            self.event_filenames[index], start_ts, end_ts)
        flow12, flow12_valid = self.load_flow(self.forward_flow_filenames[index])
        import yaml

        with open(self.calibration_filenames[index]) as f:
            calib = yaml.safe_load(f)
        intrinsics = np.array(calib["intrinsics"]["camRect0"]["camera_matrix"])
        perspectives = np.array(calib["disparity_to_depth"]["cams_03"])
        return im1, im2, events, flow12, flow12_valid, disp1, disp2, \
            intrinsics, perspectives

    def events_to_voxel_inter(self, events, num_bins, height, width,
                              event_polarity=False) -> np.ndarray:
        """DSEC voxelizer dispatcher (reference dsec.py:575-604); [C, H, W]."""
        xs = events["x"].astype(np.float32)
        ys = events["y"].astype(np.float32)
        ts = events["t"]
        ts = (ts - ts[0]).astype("float32")
        ts = ts / max(ts[-1], 1e-9)
        ps = events["p"].astype(np.float32)

        if not event_polarity:
            return events_to_voxel_trilinear(xs, ys, ts, ps, num_bins, height, width)
        pos = ps > 0
        neg = ps <= 0
        voxel_pos = events_to_voxel_trilinear(
            xs[pos], ys[pos], ts[pos], ps[pos], num_bins, height, width)
        # reference sets the negative-branch weights to the scalar 1
        voxel_neg = events_to_voxel_trilinear(
            xs[neg], ys[neg], ts[neg], np.float32(1.0), num_bins, height, width)
        return np.concatenate([voxel_pos, voxel_neg], axis=0)

    # ------------------------------------------------------------------
    def _open_preprocessed(self, path, with_events: bool = False):
        """Read one preprocessed item.

        The raw event arrays (~8 MB of the ~45 MB item) are skipped by
        default: the training pipeline consumes only the precomputed voxel
        (reference dsec.py reads them unconditionally; measured 196 ms/item
        -> the single biggest skippable cost on the preprocessed path).
        """
        import h5py

        with h5py.File(path, "r") as f:
            events = ({k: np.array(f[f"events_{k}"]) for k in ("x", "y", "t", "p")}
                      if with_events else None)
            out = dict(
                image1=np.array(f["image1"]), image2=np.array(f["image2"]),
                events=events, event_voxel=np.array(f["event_voxel"]),
                flow12=np.array(f["flow12"]), flow12_valid=np.array(f["flow12_valid"]),
                disp1=np.array(f["disp1"]) if "disp1" in f else None,
                disp2=np.array(f["disp2"]) if "disp2" in f else None,
                intrinsics=np.array(f["intrinsics"]) if "intrinsics" in f else None,
                perspectives=np.array(f["perspectives"]) if "perspectives" in f else None,
            )
        return out

    def _write_preprocessed(self, path, image1, image2, events, event_voxel,
                            flow12, flow12_valid, disp1, disp2, intrinsics,
                            perspectives):
        import h5py

        with h5py.File(path, "w") as f:
            for k in ("x", "y", "t", "p"):
                f.create_dataset(f"events_{k}", data=np.array(events[k]),
                                 compression="gzip")
            for name, arr in [("event_voxel", event_voxel), ("image1", image1),
                              ("image2", image2), ("flow12", flow12),
                              ("flow12_valid", flow12_valid), ("disp1", disp1),
                              ("disp2", disp2), ("intrinsics", intrinsics),
                              ("perspectives", perspectives)]:
                f.create_dataset(name, data=np.array(arr), compression="gzip")

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        if not self.cfgs.augmentation.enabled:
            # reference dsec.py uses seed 23333; resample_seed offsets it
            # for n_resample-averaged eval
            np.random.seed(23333 + self.resample_seed)

        pre_path = self.preprocess_list[index] if self.is_preprocess else None
        if pre_path and os.path.isfile(pre_path):
            d = self._open_preprocessed(pre_path)
            image1, image2 = d["image1"], d["image2"]
            event_voxel = d["event_voxel"]
            flow_2d, flow_2d_mask = d["flow12"], d["flow12_valid"]
            disp1, disp2 = d["disp1"], d["disp2"]
            intrinsics, perspectives = d["intrinsics"], d["perspectives"]
        else:
            image1, image2, events, flow_2d, flow_2d_mask, disp1, disp2, \
                intrinsics, perspectives = self.load_data_by_index(index)
            h, w = image1.shape[:2]
            event_voxel = self.events_to_voxel_inter(
                events, self.event_bins, h, w, self.event_polarity)
            if pre_path:
                self._write_preprocessed(pre_path, image1, image2, events,
                                         event_voxel, flow_2d, flow_2d_mask,
                                         disp1, disp2, intrinsics, perspectives)

        image_h, image_w = image1.shape[:2]
        f = intrinsics[0]
        cx, cy = intrinsics[2], intrinsics[3]
        baseline = 1.0 / perspectives[3][2]

        depth1 = baseline * f / (disp1 + 1e-6)
        depth2 = baseline * f / (disp2 + 1e-6)
        mask1 = (disp1 != np.inf) & (depth1 < self.cfgs.max_depth) & (disp1 != 0)
        mask2 = (disp2 != np.inf) & (depth2 < self.cfgs.max_depth) & (disp2 != 0)

        depth12 = flow_warp_numpy(depth2[..., None], flow_2d, 0, "bilinear")[:, :, 0]
        mask12 = (depth12 != np.inf) & (depth12 < self.cfgs.max_depth) & (depth12 != 0)

        depth1 = depth1.copy()
        depth12 = depth12.copy()
        depth1[mask1 == 0] = 1e6
        depth12[mask12 == 0] = 1e6

        mask = mask1 & mask12 & flow_2d_mask.astype(bool)
        pc1 = depth2pc(depth1, f=f, cx=cx, cy=cy)[mask]
        pc2 = depth2pc(depth12, f=f, cx=cx, cy=cy, flow=flow_2d)[mask]
        flow_3d = pc2 - pc1

        m = np.linalg.norm(flow_3d, axis=-1) < self.cfgs.max_3dflow
        pc1, flow_3d = pc1[m], flow_3d[m]
        flow_3d_mask = np.ones(flow_3d.shape[0], np.float32)

        xy2 = project_pc2image_np(pc2, image_h, image_w, f, cx, cy, clip=False)
        bmask = ((xy2[..., 0] >= 0) & (xy2[..., 0] < image_w)
                 & (xy2[..., 1] >= 0) & (xy2[..., 1] < image_h))
        pc2 = pc2[bmask]

        flow_2d = np.concatenate(
            [flow_2d.astype(np.float32),
             flow_2d_mask[..., None].astype(np.float32)], axis=-1)
        flow_3d = np.concatenate(
            [flow_3d.astype(np.float32), flow_3d_mask[..., None]], axis=-1)

        # channel-first voxel from the cache -> channels-last
        if event_voxel.shape[0] in (self.event_bins, 2 * self.event_bins):
            event_voxel = np.transpose(event_voxel, (1, 2, 0))

        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, event_voxel = \
            joint_augmentation(image1, image2, pc1, pc2, flow_2d, flow_3d,
                               f, cx, cy, self.cfgs.augmentation, event=event_voxel)

        n_points = self.cfgs.n_points
        i1 = np.random.choice(pc1.shape[0], n_points, replace=pc1.shape[0] < n_points)
        i2 = np.random.choice(pc2.shape[0], n_points, replace=pc2.shape[0] < n_points)
        pc1, flow_3d = pc1[i1], flow_3d[i1]
        pc2 = pc2[i2]

        return {
            "index": np.int32(index),
            "images": np.concatenate([image1, image2], axis=-1).astype(np.float32),
            "flow_2d": flow_2d.astype(np.float32),
            "event_voxel": event_voxel.astype(np.float32),
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": flow_3d.astype(np.float32),
            "occ_mask_2d": mask.astype(np.float32),
            "intrinsics": np.float32([f, cx, cy]),
        }


    def get_image1_path(self, i: int) -> str:
        """Reference dsec.py:789-794 accessor."""
        if self.is_preprocess and self.preprocess_list:
            return self.preprocess_list[i]
        return self.left_image1_filenames[i]


class DSECPreprocessTrain(DSECTrain):
    """Preprocessed-only DSEC listing (reference dsec.py:799-842)."""

    def __init__(self, cfgs):
        super().__init__(cfgs)
        self.is_preprocess = True

    def fetch_valids(self):
        self.is_preprocess = True
        for seq in self._base_seqs(self.preprocess_root):
            seq_dir = os.path.join(self.preprocess_root, seq)
            assert os.path.isdir(seq_dir)
            for f in sorted(os.listdir(seq_dir)):
                if f.endswith(".hdf5"):
                    self.preprocess_list.append(os.path.join(seq_dir, f))
        self.data_length = len(self.preprocess_list)
