"""The port's two HDF5 converters against the JAX package's, on the CPU.

A small raw tree of each dataset is written here (``tests/synthetic_data.py``
writes only the converted layout):

* FlyingThings3D-subset: ``pc/*.npz``, ``flow_2d/*.png`` through the 16-bit
  flow PNG encoding, ``flow_3d/*.npy``, packbit ``occ_mask_3d/*.npy``,
  ``image/*.png`` and the event streams ``<split>_events_h5/left/*.hdf5``;
  one flow index has no event stream and is skipped by both;
* EKubric: the raw tree ``KubricData._load_raw`` reads (``rgba/``,
  ``metadata/``, ``forward_flow/``, ``backward_flow/``, ``segmentation/``,
  ``depth/`` and the event streams).

The JAX converter and the port's each run on their own copy of the same raw
tree; the HDF5 trees they write hold the same files and dataset names,
shapes and dtypes, with equal values except the event voxels, which are held
at atol 1e-6 (the native scatter's gate).
"""

import json
import os
import shutil
import sys

import cv2
import h5py
import imageio
import numpy as np
import pytest

from rpeflow_tpu_torch.data.io import save_flow_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 24, 32


def _events(rng, n, h, w):
    return {"x": rng.randint(0, w, n).astype(np.float32),
            "y": rng.randint(0, h, n).astype(np.float32),
            "t": np.sort(rng.rand(n)).astype(np.float64) * 0.05,
            "p": rng.randint(0, 2, n).astype(np.float32)}


def _write_events(path, ev):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in ev.items():
            f[k] = v


def _image(rng, h, w):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def write_raw_ft3d(root, split, n_items, seed, n_pts=200, n_events=600):
    """A raw FT3D-subset split of ``n_items`` flow indices; the last has no
    event stream."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, split)
    for sub in ("pc", "flow_2d", "flow_3d", "occ_mask_3d", "image"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i in range(n_items + 1):
        cv2.imwrite(os.path.join(d, "image", "%07d.png" % i), _image(rng, H, W))
    for i in range(n_items):
        pc1 = rng.rand(n_pts, 3).astype(np.float32) * 4
        pc1[:, 2] += 2
        flow3d = (rng.randn(n_pts, 3) * 0.05).astype(np.float32)
        np.savez(os.path.join(d, "pc", "%07d.npz" % i), pc1=pc1, pc2=pc1 + flow3d)
        np.save(os.path.join(d, "flow_3d", "%07d.npy" % i), flow3d)
        np.save(os.path.join(d, "occ_mask_3d", "%07d.npy" % i),
                np.packbits(rng.rand(n_pts) > 0.7))
        save_flow_png(os.path.join(d, "flow_2d", "%07d.png" % i),
                      (rng.randn(H, W, 2) * 3).astype(np.float32), rng.rand(H, W) > 0.1)
        if i < n_items - 1:
            _write_events(os.path.join(root, split + "_events_h5", "left",
                                       "%07d_event.hdf5" % i), _events(rng, n_events, H, W))


def write_raw_kubric(root, n_seqs=2, frames=3, n_events=600):
    """A raw EKubric tree of ``n_seqs`` sequences of ``frames`` frames."""
    for s in range(n_seqs):
        seq = f"seq{s:03d}"
        rng = np.random.RandomState(10 + s)
        dirs = {k: os.path.join(root, k, seq) for k in (
            "rgba", "metadata", "forward_flow", "backward_flow", "segmentation", "depth",
            "events_i50_c0.15")}
        for p in dirs.values():
            os.makedirs(p, exist_ok=True)
        with open(os.path.join(dirs["metadata"], "metadata.json"), "w") as f:
            json.dump({"flags": {"resolution": [W, H]},
                       "camera": {"focal_length": 35.0, "sensor_width": 32.0}}, f)
        for i in range(frames):
            name = f"{i:05d}"
            cv2.imwrite(os.path.join(dirs["rgba"], name + ".png"), _image(rng, H, W))
            seg = np.zeros((H, W, 3), np.uint8)
            seg[3:H - 3, 4:W - 4] = rng.randint(1, 5, (H - 6, W - 8, 1))
            cv2.imwrite(os.path.join(dirs["segmentation"], name + ".png"), seg)
            imageio.imwrite(os.path.join(dirs["depth"], name + ".tiff"),
                            (2.0 + 8.0 * rng.rand(H, W)).astype(np.float32))
            save_flow_png(os.path.join(dirs["forward_flow"], name + ".png"),
                          (rng.randn(H, W, 2) * 2).astype(np.float32))
            save_flow_png(os.path.join(dirs["backward_flow"], name + ".png"),
                          (rng.randn(H, W, 2) * 2).astype(np.float32))
            _write_events(os.path.join(dirs["events_i50_c0.15"], name + "_event.hdf5"),
                          _events(rng, n_events, H, W))


def _run_jax(script, argv, monkeypatch):
    """``main()`` of a JAX converter (it reads ``sys.argv``), in process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_" + script[:-3], os.path.join(REPO, "scripts", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [script] + argv)
    mod.main()


def _run_port(script, argv):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(REPO, "scripts", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)


def _hdf5_tree(root, top):
    """{relative path: {dataset: array}} of every HDF5 file under ``top``."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, top)):
        for n in names:
            path = os.path.join(dirpath, n)
            with h5py.File(path, "r") as f:
                out[os.path.relpath(path, root)] = {k: np.array(f[k]) for k in f.keys()}
            with h5py.File(path, "r") as f:
                assert all(f[k].compression == "gzip" for k in f.keys()), path
    return out


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want) and want
    for path, ds in want.items():
        assert sorted(got[path]) == sorted(ds), path
        for name, val in ds.items():
            g = got[path][name]
            assert g.shape == val.shape and g.dtype == val.dtype, (path, name)
            if name == "event_voxel":
                assert np.abs(val).max() > 0, path
                np.testing.assert_allclose(g, val, rtol=0, atol=1e-6, err_msg=path)
            else:
                np.testing.assert_array_equal(g, val, err_msg=f"{path}:{name}")


@pytest.mark.parametrize("bins,polarity", [(2, 1), (3, 0)])
def test_ft3d_converter_matches_jax(bins, polarity, tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    write_raw_ft3d(str(raw), "train", 2, seed=1)
    write_raw_ft3d(str(raw), "val", 3, seed=2)
    trees = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        shutil.copytree(raw, root)
        argv = ["--input_dir", str(root), "--event_bins", str(bins),
                "--event_polarity", str(polarity), "--workers", "2"]
        if who == "jax":
            _run_jax("convert_flyingthings3d_subset_hdf5.py", argv, monkeypatch)
        else:
            _run_port("torch_convert_flyingthings3d_subset_hdf5.py", argv)
        trees[who] = {}
        for split in ("train", "val"):
            trees[who].update(_hdf5_tree(str(root), f"{split}_preprocess_ev{bins}_{polarity}"))
    assert len(trees["jax"]) == 3  # the index without an event stream is skipped
    _assert_trees_equal(trees["port"], trees["jax"])
    ds = next(iter(trees["port"].values()))
    assert ds["event_voxel"].shape == (H, W, bins * (2 if polarity else 1))


def test_kubric_converter_matches_jax(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    write_raw_kubric(str(raw))
    trees = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        shutil.copytree(raw, root)
        argv = ["--input_dir", str(root), "--event_bins", "2", "--workers", "2"]
        if who == "jax":
            _run_jax("convert_kubric_hdf5.py", argv, monkeypatch)
        else:
            _run_port("torch_convert_kubric_hdf5.py", argv)
        trees[who] = _hdf5_tree(str(root), "sf_preprocess")
    assert len(trees["jax"]) == 4  # two pairs in each of two sequences
    _assert_trees_equal(trees["port"], trees["jax"])
    ds = next(iter(trees["port"].values()))
    assert ds["pc1"].shape[0] > 0 and ds["metadata"].shape == (1, 4)
