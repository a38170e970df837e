"""The port's eval CLI against the JAX Evaluator on one checkpoint.

A synthetic FT3D tree and a mini YAML (2 samples of 64x64, 64 points,
n_samples [32, 16], k = 8) go through the JAX ``Evaluator`` and through
``python -m rpeflow_tpu_torch.eval_withocc --device cpu``, both loading one
``.pt`` saved from the port's ``state_dict()``. EPEs must agree to 1e-3
relative; threshold percentages (1px, Fl, 5cm, 10cm) to 0.5 points, as a
few elements may sit on a threshold.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from synthetic_data import write_ft3d
from torch_port_utils import small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(root, weights):
    # the JAX Evaluator builds its variables through the loss path
    losses = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l1"}
    model = dict(small_cfg_dict(), batch_size=2, n_samples=[32, 16], loss2d=losses,
                 loss3d=losses)
    return {
        "testset": {"name": "flyingthings3devent", "root_dir": root, "split": "val",
                    "n_workers": 1, "n_points": 64, "max_depth": 35.0, "event_bins": 2,
                    "event_polarity": True, "augmentation": {"enabled": False},
                    "n_resample": 1},
        "model": model,
        "ckpt": {"path": weights, "strict": True},
    }


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_cli")
    root = str(tmp / "data")
    write_ft3d(root, "val", 2, h=64, w=64, n_pts=100, bins=2, seed=1)
    weights = str(tmp / "weights.pt")
    cfg = _cfg(root, weights)
    model = seeded_init_(RPEFlow(ConfigNode(cfg["model"]), (32, 16)), seed=0)
    torch.save({"state_dict": model.state_dict()}, weights)
    cfg_path = str(tmp / "mini.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    proc = subprocess.run(
        [sys.executable, "-m", "rpeflow_tpu_torch.eval_withocc", "--config", cfg_path,
         "--weights", weights, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port = json.loads(proc.stdout.strip().splitlines()[-1])

    from rpeflow_tpu.train.evaluator import Evaluator

    ref = Evaluator(ConfigNode(cfg), with_occ=True).run()
    return port, ref


def test_cli_reports_the_jax_evaluator_keys(results):
    port, ref = results
    assert port.keys() == ref.keys()
    for key, val in port.items():
        assert np.isfinite(val), key


@pytest.mark.parametrize("key", ["EPE2d", "EPE3d", "EPE3d_noc"])
def test_cli_epe_matches_jax(results, key):
    port, ref = results
    np.testing.assert_allclose(port[key], ref[key], rtol=1e-3)


@pytest.mark.parametrize("key", ["1px", "Fl", "5cm", "10cm", "5cm_noc", "10cm_noc"])
def test_cli_percentages_match_jax(results, key):
    port, ref = results
    assert abs(port[key] - ref[key]) <= 0.5, (key, port[key], ref[key])
