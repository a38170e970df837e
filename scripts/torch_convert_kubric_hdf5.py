#!/usr/bin/env python
"""Offline raw -> sf_preprocess HDF5 packer for EKubric, on the PyTorch
port's host layer (the port's counterpart of scripts/convert_kubric_hdf5.py).

Runs the port's raw Kubric pipeline, ``rpeflow_tpu_torch.data.kubric :
KubricData._load_raw`` (intrinsics from metadata.json, bidirectional-flow
occlusion, depth lifting, event voxelization), and writes one gzip'd HDF5
per frame pair, with the JAX converter's dataset names and dtypes, into
``<root>/sf_preprocess/<seq>/``.

    python scripts/torch_convert_kubric_hdf5.py --input_dir datasets/ekubric

Host code only (numpy, cv2, imageio, h5py): it uses no card and takes no
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

from rpeflow_tpu_torch.data.kubric import KubricData  # noqa: E402
from rpeflow_tpu_torch.train.config import ConfigNode  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--event_bins", type=int, default=10)
    parser.add_argument("--event_polarity", type=int, default=1)
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    out_root = os.path.join(args.input_dir, "sf_preprocess")
    assert not os.path.isdir(out_root) or not os.listdir(out_root), (
        f"{out_root} already exists and is non-empty")

    cfg = ConfigNode({
        "root_dir": args.input_dir,
        "split": "full",
        "event_bins": args.event_bins,
        "event_polarity": bool(args.event_polarity),
        "max_flow": 250.0,
        "max_depth": 1e9,  # the raw loader output is stored unfiltered
        "max_3dflow": 1e9,
        "n_points": 8192,
        "augmentation": {"enabled": False},
    })
    ds = KubricData(cfg)
    assert not ds.is_preprocess, "raw rgba/ tree required for conversion"

    def convert_one(i):
        seq, idx1 = ds.indices[i]
        d = ds._load_raw(seq, idx1, idx1 + 1)
        out_dir = os.path.join(out_root, seq)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{idx1:05d}_preprocessed.hdf5")
        with h5py.File(out_path, "w") as f:
            for name in ("image1", "image2", "event_voxel", "flow_2d",
                         "flow_3d", "nooccmask_2d", "nooccmask_3d",
                         "pc1", "pc2"):
                if name in d and d[name] is not None:
                    f.create_dataset(name, data=np.asarray(d[name]),
                                     compression="gzip")
            f.create_dataset("flow_2d_mask", data=np.asarray(d["flow_2d_mask"]),
                             compression="gzip")
            f.create_dataset("metadata", data=d["metadata"][None],
                             compression="gzip")
        return out_path

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        futures = [pool.submit(convert_one, i) for i in range(len(ds))]
        for i, fut in enumerate(futures):
            path = fut.result()
            if (i + 1) % 50 == 0:
                print(f"[{i + 1}/{len(futures)}] {path}")


if __name__ == "__main__":
    main()
