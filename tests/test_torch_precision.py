"""The port's drivers compute in float32: building the ``Trainer`` or the
``Evaluator`` turns TF32 off for matrix products and cuDNN convolutions,
whatever the process had set (PyTorch's default for cuDNN is TF32 on).

Both are built in this process on the CPU from the inputs of the CLI tests:
a synthetic FT3D tree (``tests/synthetic_data.write_ft3d``), the training
CLI test's mini config, and a ``.pt`` saved from a seeded model.
"""

import pytest
import torch

from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.train.evaluator import Evaluator
from rpeflow_tpu_torch.train.trainer import Trainer
from synthetic_data import write_ft3d
from test_torch_train_cli import _cfg


@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("precision")
    root = str(tmp / "data")
    write_ft3d(root, "train", 2, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 2, h=64, w=64, n_pts=100, bins=2, seed=1)
    cfg = _cfg(root, str(tmp / "logs"))
    weights = str(tmp / "weights.pt")
    model = seeded_init_(RPEFlow(ConfigNode(cfg["model"]), (32, 16)), seed=0)
    torch.save({"state_dict": model.state_dict()}, weights)
    cfg["ckpt"] = {"path": weights, "resume": False, "strict": True}
    return cfg


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.usefixtures("tf32_on")
def test_trainer_turns_tf32_off(cfg):
    assert _tf32_flags() == (True, True)
    Trainer(ConfigNode(cfg), device="cpu")
    assert _tf32_flags() == (False, False)


@pytest.mark.usefixtures("tf32_on")
def test_evaluator_turns_tf32_off(cfg):
    assert _tf32_flags() == (True, True)
    Evaluator(ConfigNode(cfg), with_occ=True, device="cpu")
    assert _tf32_flags() == (False, False)
