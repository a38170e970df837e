#!/usr/bin/env python
"""Offline raw -> preprocessed-HDF5 packer for FlyingThings3D-subset, on the
PyTorch port's host layer (the port's counterpart of
scripts/convert_flyingthings3d_subset_hdf5.py).

Loads each raw sample (PNG images and 16-bit flow, npz clouds, packbit
occlusion masks, HDF5 event streams), voxelizes the events with the port's
``rpeflow_tpu_torch.data.event_voxel`` (the native scatter,
``rpeflow_tpu_torch/csrc/host_ops.cpp``, built with g++ at first use) and
writes one gzip'd HDF5 per sample, with the JAX converter's dataset names
and dtypes, into ``<split>_preprocess_ev{bins}_{polarity}/left``.

    python scripts/torch_convert_flyingthings3d_subset_hdf5.py \
        --input_dir datasets/FlyingThings3D_subset_pc [--event_bins 10]

Host code only (numpy, cv2, h5py): it uses no card and takes no
``--device``. Run it on a CPU host that has ``h5py`` (the card's machine
has none).
"""

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import h5py
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rpeflow_tpu_torch.data.event_voxel import events_to_voxel, load_events_h5  # noqa: E402
from rpeflow_tpu_torch.data.io import load_flow_png  # noqa: E402


def convert_one(root, split, idx1, event_bins, event_polarity, out_dir):
    import cv2

    split_dir = os.path.join(root, split)
    pcs = np.load(os.path.join(split_dir, "pc", "%07d.npz" % idx1))
    pc1, pc2 = pcs["pc1"], pcs["pc2"]
    flow_2d, flow_mask_2d = load_flow_png(
        os.path.join(split_dir, "flow_2d", "%07d.png" % idx1))
    flow_3d = np.load(os.path.join(split_dir, "flow_3d", "%07d.npy" % idx1))
    occ = np.load(os.path.join(split_dir, "occ_mask_3d", "%07d.npy" % idx1))
    occ = np.unpackbits(occ, count=len(pc1))
    image1 = cv2.imread(os.path.join(split_dir, "image", "%07d.png" % idx1))[..., ::-1]
    image2 = cv2.imread(os.path.join(split_dir, "image", "%07d.png" % (idx1 + 1)))[..., ::-1]

    h, w = image1.shape[:2]
    events = load_events_h5(os.path.join(
        root, split + "_events_h5", "left", "%07d_event.hdf5" % idx1))
    event_voxel = events_to_voxel(events, event_bins, h, w, event_polarity)

    out_path = os.path.join(out_dir, "%07d_preprocessed.hdf5" % idx1)
    with h5py.File(out_path, "w") as f:
        for name, arr in [
            ("image1", image1), ("image2", image2), ("event_voxel", event_voxel),
            ("flow_2d", flow_2d), ("flow_mask_2d", flow_mask_2d),
            ("flow_3d", flow_3d), ("occ_mask_3d", occ),
            ("pc1", pc1), ("pc2", pc2),
        ]:
            f.create_dataset(name, data=np.asarray(arr), compression="gzip")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--event_bins", type=int, default=10)
    parser.add_argument("--event_polarity", type=int, default=1)
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    for split in ("train", "val"):
        split_dir = os.path.join(args.input_dir, split)
        if not os.path.isdir(split_dir):
            continue
        print(f'Processing "{split}" split...')
        event_dir = os.path.join(args.input_dir, split + "_events_h5", "left")
        out_dir = os.path.join(
            args.input_dir,
            f"{split}_preprocess_ev{args.event_bins}_{args.event_polarity}",
            "left")
        os.makedirs(out_dir, exist_ok=True)

        indices = []
        for filename in os.listdir(os.path.join(split_dir, "flow_2d")):
            idx = filename.split(".")[0]
            if os.path.isfile(os.path.join(event_dir, idx + "_event.hdf5")):
                indices.append(int(idx))

        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            futures = [
                pool.submit(convert_one, args.input_dir, split, idx,
                            args.event_bins, bool(args.event_polarity), out_dir)
                for idx in sorted(indices)
            ]
            for i, fut in enumerate(futures):
                path = fut.result()
                if (i + 1) % 50 == 0:
                    print(f"  [{i + 1}/{len(futures)}] {path}")


if __name__ == "__main__":
    main()
