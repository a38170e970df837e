"""The port's ``amp`` scope against the JAX package's: bfloat16 inside the RGB
and event 2-D feature pyramids only (``rpeflow_tpu/model/core.py``,
``pyr_dtype`` and ``_from_pyr``), everything else float32.

Small model of tests/test_torch_model.py (64x64, 64 points, n_samples
(32, 16), k = 8), batch 2, weights ``fill_variables`` seed 1, the eval
forward (running batch-norm statistics). JAX's graphs are compiled with
``xla_allow_excess_precision`` off: XLA:CPU otherwise keeps the bfloat16
values inside a fusion in float32, where the program -- and the port --
round them at every operation.

Tolerances (bfloat16 keeps 8 significant bits): each pyramid level's output
within 2^-6 of the level's largest entry (4 bfloat16 steps there). The amp
forward's flows, where the pyramids' rounding has passed through the whole
decode, within the effect of bfloat16 itself: max |d| no larger than that
of JAX's float32 flows from JAX's amp ones, and mean |d| below 2e-2 (the
float32 forward's mean bound, tests/test_wrapper_parity.py).
Discriminating: the port's amp output is closer, in mean |d|, to JAX's amp
output than JAX's float32 output is (the readings are in PERF.md, PR 8).
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu.train.factory import model_factory as jax_model_factory
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.train.config import ConfigNode as PortConfigNode
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.state import train_step
from synthetic_data import write_ft3d
from torch_port_utils import fill_variables, make_inputs, small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = (32, 16)
PYRAMIDS = ("feature_pyramid_2d", "efeature_pyramid_2d")
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT_BF16)(*args)


@pytest.fixture(scope="module")
def amp():
    """JAX's amp and float32 outputs, and the port's amp model, on one set of
    weights and inputs: ``{"jax_amp" | "jax_f32": {name: outputs}},
    model, batch``; ``name`` is a pyramid or ``forward``."""
    losses = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
    cfg = ConfigNode(dict(small_cfg_dict(), name="RPEFlow", n_samples=list(N_SAMPLES),
                          loss2d=losses, loss3d=losses))
    batch = make_inputs(0)
    models = {"jax_amp": jax_model_factory(cfg, amp=True), "jax_f32": jax_model_factory(cfg)}
    shapes = jax.eval_shape(
        lambda x: models["jax_amp"].init({"params": jax.random.PRNGKey(0),
                                          "mi": jax.random.PRNGKey(1)},
                                         x, train=True, compute_mi=True), batch)
    variables = fill_variables(shapes, seed=1)
    inputs = {"feature_pyramid_2d": batch["images"][..., :3].astype(np.float32) / 255.0,
              "efeature_pyramid_2d": batch["event_voxel"]}
    out = {}
    for key, jm in models.items():
        out[key] = {"forward": _jit(lambda v, x: jm.apply(v, x, train=False)[0], variables,
                                    batch)}
        for name in PYRAMIDS:
            out[key][name] = _jit(lambda v, x, name=name: jm.apply(
                v, x, method=lambda m, x: getattr(m.pwc_fusion_core, name)(x, train=False)),
                variables, jnp.asarray(inputs[name]))
    model = RPEFlow(cfg, N_SAMPLES, amp=True)
    load_jax_variables(model, variables, strict=True)
    return out, model, batch, inputs


def _f64(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("name", PYRAMIDS)
def test_amp_pyramid_matches_jax_amp(amp, name):
    out, model, _, inputs = amp
    with torch.inference_mode():
        got = getattr(model.pwc_fusion_core, name)(torch.from_numpy(inputs[name]))
    assert len(got) == len(out["jax_amp"][name]) == 3
    for level, (g, want, f32) in enumerate(zip(got, out["jax_amp"][name], out["jax_f32"][name])):
        assert g.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, (g.dtype, want.dtype)
        g, want, f32 = g.double().numpy(), _f64(want), _f64(f32)
        d = np.abs(g - want)
        print(f"{name} level {level}: max|d| {d.max():.3e} of max|ref| {np.abs(want).max():.3f}"
              f", mean|d| {d.mean():.3e}; JAX f32 vs amp mean|d| {np.abs(f32 - want).mean():.3e}")
        assert d.max() <= 2.0 ** -6 * np.abs(want).max(), (level, d.max())
        assert d.mean() < np.abs(f32 - want).mean(), level


@pytest.mark.parametrize("key", ["flow_2d", "flow_3d"])
def test_amp_forward_matches_jax_amp(amp, key):
    out, model, batch, _ = amp
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})[key]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want, f32 = _f64(out["jax_amp"]["forward"][key]), _f64(out["jax_f32"]["forward"][key])
    d, d_bf16 = np.abs(got.double().numpy() - want), np.abs(f32 - want)
    print(f"amp {key}: max|d| {d.max():.3e}, mean|d| {d.mean():.3e}; JAX f32 vs amp max|d| "
          f"{d_bf16.max():.3e}, mean|d| {d_bf16.mean():.3e}")
    assert d.max() <= d_bf16.max() and d.mean() < d_bf16.mean(), (d.max(), d.mean())
    assert d.mean() < 2e-2


def test_only_the_pyramids_compute_in_bf16(amp):
    """Forward hooks on every module through one amp training step: every
    module under the two 2-D pyramids returns bfloat16, every other module
    float32 (or integers); the encoder hands the decoder float32, equal to
    the pyramids' bfloat16 values; the step is finite."""
    _, model, batch, inputs = amp
    model = copy.deepcopy(model)
    dtypes = {}

    def hook(module, args, output):
        outs = output if isinstance(output, (list, tuple)) else [output]
        dtypes.setdefault(names[module], set()).update(
            t.dtype for t in outs if torch.is_tensor(t) and t.is_floating_point())

    names = {m: n for n, m in model.named_modules()}
    handles = [m.register_forward_hook(hook) for m in names]
    train = dict(make_inputs(0, targets=True))
    train["flow_3d"] = np.concatenate([train["flow_3d"], 1 - train.pop("occ_mask_3d")[..., None]],
                                      -1)
    cfg = PortConfigNode({"max_epochs": 1, "optimizer": "adam", "weight_decay": 0.0,
                          "lr": {"scheduler": "MultiStepLR", "init_value": 1e-4,
                                 "decay_rate": 0.5, "decay_milestones": [5]}})
    try:
        summary = train_step(model.train(), optimizer_factory(cfg, model, 10),
                             {k: torch.from_numpy(v) for k, v in train.items()},
                             torch.Generator().manual_seed(0))
    finally:
        for h in handles:
            h.remove()
        model.eval()
    assert all(np.isfinite(v) for v in summary.values()), summary
    in_scope = [n for n in dtypes if any(f"{n}.".startswith(f"pwc_fusion_core.{p}.")
                                         for p in PYRAMIDS)]
    assert len(in_scope) > 20
    for name, seen in dtypes.items():
        want = {torch.bfloat16} if name in in_scope else {torch.float32}
        assert seen <= want, (name, seen)
    core = model.pwc_fusion_core
    with torch.inference_mode():
        x = torch.from_numpy(inputs["efeature_pyramid_2d"])
        for raw, handed in zip(core.efeature_pyramid_2d(x), core.encode_event(x)):
            assert raw.dtype == torch.bfloat16 and handed.dtype == torch.float32
            assert torch.equal(raw.float(), handed)


def test_amp_trains_through_the_cli(tmp_path):
    """``python -m rpeflow_tpu_torch.train --device cpu`` with ``amp: true``:
    2 steps with finite losses and a validation."""
    from test_torch_train_cli import _cfg

    root = str(tmp_path / "data")
    write_ft3d(root, "train", 4, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 2, h=64, w=64, n_pts=100, bins=2, seed=1)
    cfg = dict(_cfg(root, str(tmp_path / "logs")), amp=True)
    cfg["log"]["save_ckpt"] = False
    cfg_path = str(tmp_path / "amp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.train", "--config", cfg_path,
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = proc.stderr
    assert "amp: the 2-D feature pyramids compute in bfloat16" in log
    steps = re.findall(r"E1 S(\d+) \[\d+/2\] loss: ([-\d.naif]+)", log)
    assert [s for s, _ in steps] == ["1", "2"], log[-2000:]
    assert all(np.isfinite(float(v)) for _, v in steps), steps
    assert "Validation:" in log
