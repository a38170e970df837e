"""The port's visualization module and the trainer's summaries.

``rpeflow_tpu_torch.utils.visualization`` against
``rpeflow_tpu.utils.visualization`` on the same numpy inputs: every public
function, equal arrays and equal file bytes. Then ``python -m
rpeflow_tpu_torch.train --device cpu`` for one epoch of 2 steps on a
synthetic FT3D tree (the mini config of tests/test_torch_train_cli.py, with
``log.profile_steps: [0, 1]``): the TensorBoard scalars are the JAX
trainer's tags (``train/<k>`` for every key of its train-step summary,
``train/lr``, ``val/<k>`` for every key of its eval summary) plus the image
``val/flow_2d_pred``, read back with ``EventAccumulator``, and a
``torch.profiler`` trace lies under ``<log.dir>/profile``, with the
program's ``rpeflow.*`` spans of the recorded step. Without
``tensorboardX`` the trainer still trains and writes no event file.
"""

import glob
import gzip
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

import rpeflow_tpu.utils.visualization as jax_vis
import rpeflow_tpu_torch.utils.visualization as vis
from rpeflow_tpu.model.rpeflow import flow_metrics
from synthetic_data import write_ft3d
from test_torch_train_cli import REPO, _cfg


def _events():
    rng = np.random.RandomState(3)
    n = 200
    return np.stack([rng.randint(0, 24, n), rng.randint(0, 16, n), np.sort(rng.rand(n)),
                     rng.choice([-1, 1], n)], -1).astype(np.float32)


def _flow():
    flow = (np.random.RandomState(4).randn(12, 20, 2) * 3).astype(np.float32)
    flow[0, 0] = np.nan
    return flow


_ARRAYS = {
    "make_colorwheel": lambda m: m.make_colorwheel(),
    "flow_to_image": lambda m: m.flow_to_image(_flow()),
    "flow_to_image max_flow": lambda m: m.flow_to_image(_flow(), max_flow=2.0),
    "scene_flow_to_image": lambda m: m.scene_flow_to_image(
        np.random.RandomState(5).randn(50, 3).astype(np.float32)),
    "event_voxel_to_image": lambda m: m.event_voxel_to_image(
        np.random.RandomState(6).randn(16, 24, 6).astype(np.float32)),
    "event_voxel_to_image one bin": lambda m: m.event_voxel_to_image(
        np.random.RandomState(7).randn(16, 24, 1).astype(np.float32)),
    "events_to_grey_image": lambda m: m.events_to_grey_image(_events()),
    "events_to_color_image": lambda m: m.events_to_color_image(_events()),
    "events_to_color_image white": lambda m: m.events_to_color_image(_events(), "white"),
}


@pytest.mark.parametrize("name", list(_ARRAYS))
def test_renders_equal_the_jax_package(name):
    ours, ref = _ARRAYS[name](vis), _ARRAYS[name](jax_vis)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


_WRITERS = {
    "write_event_voxel_preview": lambda m, p: m.write_event_voxel_preview(
        p, np.abs(np.random.RandomState(8).randn(16, 24, 4)).astype(np.float32)),
    "write_events_voxel_preview": lambda m, p: m.write_events_voxel_preview(p, _events(), 3),
    "write_events_grey": lambda m, p: m.write_events_grey(p, _events()),
    "write_events_color": lambda m, p: m.write_events_color(p, _events()),
    "write_events_color crop": lambda m, p: m.write_events_color(p, _events(), (8, 10)),
}


@pytest.mark.parametrize("name", list(_WRITERS))
def test_writers_equal_the_jax_package(tmp_path, name):
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    _WRITERS[name](vis, ours)
    _WRITERS[name](jax_vis, ref)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_every_public_function_is_ported_and_checked():
    public = {n for n in dir(jax_vis) if not n.startswith("_") and callable(getattr(jax_vis, n))
              and getattr(jax_vis, n).__module__ == jax_vis.__name__}
    assert public <= set(dir(vis))
    checked = {k.split()[0] for k in (*_ARRAYS, *_WRITERS)}
    assert public == checked


def _jax_tags():
    """The JAX trainer's scalar tags (rpeflow_tpu/train/trainer.py): its
    train step's summary (the model's losses and flow metrics, grad_norm),
    lr, and its eval step's summary."""
    t2d, t3d = jnp.zeros((1, 4, 4, 3)), jnp.zeros((1, 8, 4))
    metrics = set(flow_metrics(jnp.zeros((1, 4, 4, 2)), jnp.zeros((1, 8, 3)), t2d, t3d))
    model = {"loss", "loss_2d", "loss_3d", "mi_loss"} | metrics
    return ({f"train/{k}" for k in model | {"grad_norm", "lr"}}
            | {f"val/{k}" for k in model})


def _write_tree(tmp, profile):
    root = str(tmp / "data")
    write_ft3d(root, "train", 4, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 2, h=64, w=64, n_pts=100, bins=2, seed=1)
    cfg = _cfg(root, str(tmp / "logs"))
    cfg["log"]["save_ckpt"] = False
    if profile:
        cfg["log"]["profile_steps"] = [0, 1]
    path = str(tmp / "mini.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, str(tmp / "logs")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg_path, log_dir = _write_tree(tmp_path_factory.mktemp("summaries"), profile=True)
    proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.train", "--config",
                           cfg_path, "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return log_dir


def test_trainer_writes_the_jax_trainers_tags_and_the_flow_image(run):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(run, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["scalars"]) == _jax_tags()
    assert tags["images"] == ["val/flow_2d_pred"]
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2]
    assert all(np.isfinite(e.value) for e in acc.Scalars("train/loss"))
    assert [e.step for e in acc.Scalars("val/outlier2d")] == [2]
    image = acc.Images("val/flow_2d_pred")
    assert [e.step for e in image] == [2] and (image[0].height, image[0].width) == (64, 64)


def test_profile_steps_leave_a_trace(run):
    traces = glob.glob(os.path.join(run, "profile", "*.json*"))
    assert traces and all(os.path.getsize(t) > 0 for t in traces)


def test_profile_steps_trace_shows_the_program_spans(run):
    """The trainer's trace holds the program's ``rpeflow.*`` spans of the
    step it recorded (``record_spans`` on for its window)."""
    names = set()
    for path in glob.glob(os.path.join(run, "profile", "*.json*")):
        with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
            names |= {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rpeflow.train_step", "rpeflow.train_step.backward", "rpeflow.train_step.update",
            "rpeflow.forward", "rpeflow.forward.decode.level1"} <= names


def test_trainer_without_tensorboardx_trains_and_writes_no_summaries(tmp_path, monkeypatch):
    from rpeflow_tpu_torch.train.config import load_config
    from rpeflow_tpu_torch.train.trainer import Trainer

    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    cfg_path, log_dir = _write_tree(tmp_path, profile=False)
    trainer = Trainer(load_config(cfg_path), device="cpu")
    assert trainer.summary_writer is None
    trainer.run()
    assert trainer.optimizer.step_count == 2
    assert np.isfinite(trainer.best_metrics["outlier2d"])
    assert not glob.glob(os.path.join(log_dir, "events.out.tfevents*"))
