"""The port's own host layer against the JAX package's modules it copies.

``rpeflow_tpu_torch.train.config`` (``ConfigNode``, ``load_config``),
``rpeflow_tpu_torch.train.factory`` (``dataset_factory``),
``rpeflow_tpu_torch.data`` (datasets, augmentation, ``DataLoader``, event
voxels) and ``rpeflow_tpu_torch.compat.to_torch_state_dict`` against
``rpeflow_tpu.train.config``, ``.train.factory``, ``rpeflow_tpu.data`` and
``rpeflow_tpu.compat.torch_loader``. Arrays must be equal; event voxels are
held to atol 1e-6, since the JAX package may sum them through its native
scatter in another order.
"""

import glob
import os

import numpy as np
import pytest

import jax

from rpeflow_tpu.compat import torch_loader as jax_torch_loader
from rpeflow_tpu.data import dsec as jax_dsec
from rpeflow_tpu.data import event_voxel as jax_event_voxel
from rpeflow_tpu.data.loader import DataLoader as JaxDataLoader
from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train import config as jax_config
from rpeflow_tpu.train.factory import dataset_factory as jax_dataset_factory
from rpeflow_tpu_torch.compat import to_torch_state_dict
from rpeflow_tpu_torch.data import dsec, event_voxel
from rpeflow_tpu_torch.data.loader import DataLoader
from rpeflow_tpu_torch.train import config
from rpeflow_tpu_torch.train.factory import dataset_factory
from synthetic_data import write_dsec, write_ft3d, write_kubric
from torch_port_utils import fill_variables, make_inputs, small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "conf", "**",
                                                                          "*.yaml"),
                                                             recursive=True))
OVERRIDES = ["training.max_epochs=3", "model.pwc3d.k=8", "model.n_samples=[64, 32]",
             "new.nested.key=none-of-these", "log.dir=/tmp/x", "seed=1.5e-3"]

AUGMENT = {
    "enabled": True,
    "color_jitter": {"enabled": True, "brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                     "hue": 0.127},
    "random_horizontal_flip": {"enabled": True},
    "random_vertical_flip": {"enabled": True},
    "random_crop": {"enabled": False},
    "random_scale": {"enabled": False},
}
# the synthetic FT3D points do not project into a 64x64 image under the FT3D
# intrinsics, so cropping and zooming are held on their own
# (test_joint_augmentation_matches_jax)
CROP_SCALE = dict(AUGMENT, random_crop={"enabled": True, "crop_size": [48, 40]},
                  random_scale={"enabled": True, "scale_range": [1.0, 1.3]})


def _assert_items_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for key, val in want.items():
        atol = 1e-6 if key == "event_voxel" else 0.0
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(val), rtol=0, atol=atol,
                                   err_msg=f"{what}: {key}")
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype, (what, key)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_loads_like_jax(path):
    full = os.path.join(REPO, path)
    got = config.load_config(full, OVERRIDES)
    want = jax_config.load_config(full, OVERRIDES)
    assert isinstance(got, config.ConfigNode)
    assert got.to_dict() == want.to_dict()
    assert got.model.n_samples == [64, 32] and got.new.nested.key == "none-of-these"
    merged = got.merge({"model": {"batch_size": 3}})
    assert merged.to_dict() == want.merge({"model": {"batch_size": 3}}).to_dict()
    assert got.model.batch_size == want.model.batch_size  # merge copies


def _ft3d_cfg(root, split, augmentation):
    return {"name": "flyingthings3devent", "root_dir": root, "split": split, "n_workers": 1,
            "n_points": 64, "max_depth": 35.0, "event_bins": 2, "event_polarity": True,
            "augmentation": augmentation}


@pytest.fixture(scope="module")
def ft3d_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ft3d") / "data")
    write_ft3d(root, "train", 5, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 3, h=64, w=64, n_pts=64, bins=2, seed=1)
    return root


@pytest.mark.parametrize("split,augment", [("train", False), ("train", True), ("val", False)])
def test_ft3d_items_match_jax(ft3d_root, split, augment):
    cfg = _ft3d_cfg(ft3d_root, split, AUGMENT if augment else {"enabled": False})
    got_set = dataset_factory(config.ConfigNode(cfg))
    want_set = jax_dataset_factory(jax_config.ConfigNode(cfg))
    assert type(got_set).__name__ == type(want_set).__name__
    assert len(got_set) == len(want_set) > 0
    for i in range(len(want_set)):
        np.random.seed(100 + i)  # the augmentation draws from the global RNG
        want = want_set[i]
        np.random.seed(100 + i)
        _assert_items_equal(got_set[i], want, f"{split} item {i}")


def test_concat_factory_and_loader_batches_match_jax(ft3d_root):
    """``trainset1`` + ``trainset2`` through ``dataset_factory`` and a
    shuffled, sharded ``DataLoader`` over two epochs."""
    cfg = {"trainset1": _ft3d_cfg(ft3d_root, "train", {"enabled": False}),
           "trainset2": _ft3d_cfg(ft3d_root, "val", {"enabled": False})}
    got_set = dataset_factory(config.ConfigNode(cfg))
    want_set = jax_dataset_factory(jax_config.ConfigNode(cfg))
    assert len(got_set) == len(want_set) == 8
    kwargs = dict(batch_size=4, shuffle=True, drop_last=True, seed=3, num_workers=1,
                  shard_index=1, num_shards=2, use_process_pool=False)
    got_loader, want_loader = DataLoader(got_set, **kwargs), JaxDataLoader(want_set, **kwargs)
    assert len(got_loader) == len(want_loader) == 2
    for epoch in (1, 2):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 2
        for j, (g, w) in enumerate(zip(got, want)):
            assert g["images"].shape[0] == 2
            _assert_items_equal(g, w, f"epoch {epoch} batch {j}")


def test_kubric_and_dsec_items_match_jax(tmp_path):
    write_kubric(str(tmp_path / "kubric"), n_seqs=5)
    write_dsec(str(tmp_path / "dsec"))
    cfgs = [
        {"name": "kubric", "root_dir": str(tmp_path / "kubric"), "split": "train",
         "event_bins": 2, "event_polarity": True, "max_flow": 250.0, "max_depth": 90.0,
         "max_3dflow": 5.0, "n_points": 128, "augmentation": {"enabled": False}},
        {"name": "dsecpreprocesstrain", "root_dir": str(tmp_path / "dsec"), "split": "val",
         "data_seq": "full", "isbi": False, "n_workers": 1, "max_depth": 35, "max_flow": 100,
         "max_3dflow": 2.0, "n_points": 128, "use_preprocess": True, "event_bins": 2,
         "event_polarity": True, "augmentation": {"enabled": False}},
    ]
    for cfg in cfgs:
        got_set = dataset_factory(config.ConfigNode(cfg))
        want_set = jax_dataset_factory(jax_config.ConfigNode(cfg))
        assert len(got_set) == len(want_set) > 0, cfg["name"]
        for i in range(min(len(want_set), 3)):
            np.random.seed(i)
            want = want_set[i]
            np.random.seed(i)
            _assert_items_equal(got_set[i], want, f"{cfg['name']} item {i}")


@pytest.mark.parametrize("seed", range(4))
def test_joint_augmentation_matches_jax(seed):
    from rpeflow_tpu.data.augmentation import joint_augmentation as jax_joint_augmentation
    from rpeflow_tpu_torch.data.augmentation import joint_augmentation

    b = make_inputs(seed, b=1, h=56, w=64, n=200, event_ch=4, targets=True)
    f, cx, cy = (float(v) for v in b["intrinsics"][0])
    pcs = b["pcs"][0]
    args = (b["images"][0, ..., :3], b["images"][0, ..., 3:], pcs[:, :3], pcs[:, 3:],
            b["flow_2d"][0], b["flow_3d"][0], f, cx, cy)
    np.random.seed(seed)
    want = jax_joint_augmentation(*args, jax_config.ConfigNode(CROP_SCALE),
                                  event=b["event_voxel"][0])
    np.random.seed(seed)
    got = joint_augmentation(*args, config.ConfigNode(CROP_SCALE), event=b["event_voxel"][0])
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"output {i}")


@pytest.mark.parametrize("polarity", [False, True])
def test_event_voxels_match_jax(rng, polarity):
    n, h, w, bins = 5000, 48, 64, 5
    events = np.stack([rng.randint(0, w, n), rng.randint(0, h, n),
                       np.sort(rng.rand(n)) * 1e5, rng.randint(0, 2, n)], 1).astype(np.float32)
    got = event_voxel.events_to_voxel(events, bins, h, w, polarity)
    want = jax_event_voxel.events_to_voxel(events, bins, h, w, polarity)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dsec_trilinear_voxels_match_jax(rng):
    n, h, w, bins = 5000, 48, 64, 5
    xs = (rng.rand(n) * (w + 2) - 1).astype(np.float32)
    ys = (rng.rand(n) * (h + 2) - 1).astype(np.float32)
    ts = np.sort(rng.rand(n)).astype(np.float64) * 1e5
    ps = rng.randint(0, 2, n).astype(np.float32)
    got = dsec.events_to_voxel_trilinear(xs, ys, ts, ps, bins, h, w)
    want = jax_dsec.events_to_voxel_trilinear(xs, ys, ts, ps, bins, h, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_state_dict_export_matches_jax():
    """The full model's variable tree (``jax.eval_shape`` of ``init``, filled
    with numpy) renamed by both bridges: the same keys, equal arrays."""
    cfg = jax_config.ConfigNode(small_cfg_dict())
    model = JaxRPEFlow(cfgs=cfg, n_samples_list=(32, 16))
    batch = make_inputs(0)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                             x, train=True, compute_mi=True), batch)
    variables = fill_variables(shapes, seed=2)
    got = to_torch_state_dict(variables)
    want = jax_torch_loader.to_torch_state_dict(variables)
    assert len(want) > 500
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key].shape == val.shape and got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)
