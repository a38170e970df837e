"""A checkpoint of the JAX trainer reaches the port: the JAX
``CheckpointManager`` saves a small model's TrainState (an orbax directory
and its ``.meta.json``), ``scripts/export_torch_checkpoint.py`` writes the
port's ``.pt`` from it, and the port's ``compat.load_checkpoint`` loads it
strictly, every tensor bitwise equal to ``to_torch_state_dict`` of the saved
variables. The port's loaders refuse a directory with a ``ValueError``
naming the script, and its train CLI accepts the reference's ``--port``."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train.checkpoint import CheckpointManager
from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
from rpeflow_tpu.train.optim import optimizer_factory as jax_optimizer_factory
from rpeflow_tpu.train.state import create_train_state
from rpeflow_tpu_torch import compat
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.train import checkpoint as port_checkpoint
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.trainer import parser
from torch_port_utils import fill_variables, make_inputs, small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = (32, 16)
TRAINING = {"max_epochs": 4, "optimizer": "adam", "weight_decay": 1e-6, "bias_decay": 0.0,
            "lr": {"scheduler": "MultiStepLR", "init_value": 4e-4, "decay_rate": 0.5,
                   "decay_milestones": [2, 3]}}


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(REPO, "scripts", "export_torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX TrainState of the small model (fused Adam's state, step 7)
    saved by ``CheckpointManager``; returns (orbax dir, its variables)."""
    model = JaxRPEFlow(cfgs=JaxConfigNode(small_cfg_dict()), n_samples_list=N_SAMPLES)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                             x, train=True, compute_mi=True), make_inputs(0))
    variables = fill_variables(shapes, seed=4)
    tx, _ = jax_optimizer_factory(JaxConfigNode(TRAINING), variables["params"],
                                  steps_per_epoch=2)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    state = state.replace(step=state.step + 7)
    tmp = tmp_path_factory.mktemp("orbax")
    CheckpointManager(str(tmp)).save("epoch-003", state, last_epoch=3,
                                     best_metrics={"EPE2d": 1.25, "EPE3d": 0.5})
    return str(tmp / "epoch-003"), variables


def test_export_loads_strictly_and_bitwise(saved, tmp_path, capsys):
    ckpt, variables = saved
    out = str(tmp_path / "exported.pt")
    assert _export_tool().main(["--ckpt", ckpt, "--out", out]) == 0
    assert "wrote" in capsys.readouterr().out

    payload = torch.load(out, map_location="cpu", weights_only=True)
    assert set(payload) == {"last_epoch", "last_step", "state_dict", "best_metrics"}
    assert payload["last_epoch"] == 3 and payload["last_step"] == 7
    assert payload["best_metrics"] == {"EPE2d": 1.25, "EPE3d": 0.5}

    port = RPEFlow(ConfigNode(small_cfg_dict()), N_SAMPLES)
    result = compat.load_checkpoint(port, out, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    want = to_torch_state_dict(variables)
    got = port.state_dict()
    assert got.keys() == want.keys() and len(want) > 500
    for name, val in want.items():
        assert got[name].dtype == torch.from_numpy(np.asarray(val)).dtype, name
        np.testing.assert_array_equal(got[name].numpy(), val, err_msg=name)

    # the exported file starts a fine-tune (a non-strict transfer that leaves
    # nothing behind) but not a resume: it holds no optimizer state
    fresh = RPEFlow(ConfigNode(small_cfg_dict()), N_SAMPLES)
    assert port_checkpoint.load_weights(out, fresh) == []
    opt = optimizer_factory(ConfigNode(TRAINING), fresh, steps_per_epoch=2)
    with pytest.raises(ValueError, match="without --resume"):
        port_checkpoint.restore_checkpoint(out, fresh, opt)
    assert opt.step_count == 0


def test_port_loaders_refuse_a_directory(saved):
    ckpt, _ = saved
    model = RPEFlow(ConfigNode(small_cfg_dict()), N_SAMPLES)
    calls = [lambda: compat.load_checkpoint(model, ckpt),
             lambda: port_checkpoint.load_weights(ckpt, model),
             lambda: port_checkpoint.restore_checkpoint(ckpt, model, None)]
    for call in calls:
        with pytest.raises(ValueError, match="scripts/export_torch_checkpoint.py"):
            call()


def test_train_cli_accepts_the_reference_port_flag():
    args = parser().parse_args(["--config", "conf/train/pretrain.yaml", "--port", "1234",
                                "--device", "cpu"])
    assert args.port == "1234" and args.config == "conf/train/pretrain.yaml"
    assert parser().parse_args([]).port is None
