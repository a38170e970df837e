"""``python -m rpeflow_tpu_torch.train --device cpu`` end to end.

A synthetic FT3D tree (4 training and 2 validation samples of 64x64, 100
points) and a mini YAML (batch 2, 64 points, n_samples [32, 16], k = 8):
one epoch is 2 steps and one validation, and writes ``best.pt`` and
``epoch-001.pt``. A second run resumes from ``epoch-001.pt`` for epoch 2.
``python -m rpeflow_tpu_torch.eval_withocc`` then loads ``best.pt``
strictly into the eval model.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from synthetic_data import write_ft3d
from torch_port_utils import small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(root, log_dir):
    ds = {"name": "flyingthings3devent", "root_dir": root, "n_workers": 1, "n_points": 64,
          "max_depth": 35.0, "event_bins": 2, "event_polarity": True,
          "augmentation": {"enabled": False}}
    losses = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
    return {
        "trainset": dict(ds, split="train", drop_last=True),
        "valset": dict(ds, split="val"),
        "testset": dict(ds, split="val", n_resample=1),
        "model": dict(small_cfg_dict(), batch_size=2, freeze_bn=False, n_samples=[32, 16],
                      loss2d=losses, loss3d=losses),
        "training": {"max_epochs": 1, "optimizer": "adam",
                     "lr": {"scheduler": "MultiStepLR", "init_value": 1e-4, "decay_rate": 0.5,
                            "decay_milestones": [5]},
                     "weight_decay": 1e-6, "bias_decay": 0.0},
        "log": {"dir": log_dir, "save_ckpt": True, "save_ckpt_every_n_epochs": 1},
        "ckpt": {"path": None, "resume": False, "strict": True},
        "seed": 0,
    }


def _run(module, *args):
    proc = subprocess.run([sys.executable, "-m", module, *args, "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    root = str(tmp / "data")
    write_ft3d(root, "train", 4, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 2, h=64, w=64, n_pts=100, bins=2, seed=1)
    log_dir = str(tmp / "logs")
    cfg_path = str(tmp / "mini.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_cfg(root, log_dir), f)
    first = _run("rpeflow_tpu_torch.train", "--config", cfg_path)
    resumed = _run("rpeflow_tpu_torch.train", "--config", cfg_path, "--weights",
                   os.path.join(log_dir, "epoch-001.pt"), "--resume",
                   "--overrides", "training.max_epochs=2")
    return cfg_path, log_dir, first.stderr, resumed.stderr


def test_trains_validates_and_checkpoints(run):
    _, log_dir, log, _ = run
    steps = re.findall(r"E1 S(\d+) \[\d+/2\] loss: ([-\d.naif]+)", log)
    assert [s for s, _ in steps] == ["1", "2"], log[-2000:]
    assert all(np.isfinite(float(v)) for _, v in steps)
    assert "Validation:" in log and "New best" in log
    for name in ("best.pt", "epoch-001.pt"):
        ckpt = torch.load(os.path.join(log_dir, name), map_location="cpu", weights_only=True)
        assert ckpt["last_epoch"] == 1 and ckpt["last_step"] == 2
        assert np.isfinite(ckpt["best_metrics"]["outlier2d"])
        assert ckpt["optimizer"]["step"] == 2


def test_resume_continues_at_epoch_2(run):
    _, log_dir, _, log = run
    assert re.findall(r"E(\d) S(\d+) ", log) == [("2", "3"), ("2", "4")], log[-2000:]
    ckpt = torch.load(os.path.join(log_dir, "epoch-002.pt"), map_location="cpu",
                      weights_only=True)
    assert ckpt["last_epoch"] == 2 and ckpt["last_step"] == 4


def test_eval_cli_loads_the_checkpoint_strictly(run):
    cfg_path, log_dir, _, _ = run
    proc = _run("rpeflow_tpu_torch.eval_withocc", "--config", cfg_path, "--weights",
                os.path.join(log_dir, "best.pt"))
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values()), metrics
