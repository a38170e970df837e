"""DSEC and EKubric through the port's entry points, against the JAX package.

Synthetic preprocessed trees (``synthetic_data.write_dsec`` and
``write_kubric``, 64x96 frames, 2 event bins) are written in the test's
own tmp dir; a fifth of DSEC's ``flow12_valid`` pixels are then set
invalid, their ``flow12`` to -256 px (what DSEC's 16-bit PNG decodes a
zero to), so the metrics and the losses must take their sparse branches.

* The eval CLIs: ``python -m rpeflow_tpu_torch.eval_noocc --device cpu``
  on the DSEC tree and ``eval_withocc`` on the EKubric tree, each loading a
  ``.pt`` of seeded weights, against the JAX ``Evaluator`` (``with_occ``
  False / True) on the same tree and config. The config is the shipped
  ``conf/test/{dsec,ekubric}.yaml`` with its sizes cut: 64 points,
  n_samples [32, 16], 2 event bins, batch 2, one loader worker. The keys
  must be equal (DSEC has no ``_noc`` keys); EPEs agree to 1e-3 relative,
  percentages to 0.5 points, as in tests/test_torch_eval_cli.py.
* The trainer: ``python -m rpeflow_tpu_torch.train --device cpu`` on the
  shipped ``conf/train/{dsec,ekubric}.yaml`` with only the data roots,
  ``log.dir``, ``training.max_epochs`` 1, batch 2 and the sizes above
  overridden: two steps with finite losses and a ``Validation:`` line;
  and the learning rate of the trainer's optimizer (the ``Trainer`` resuming
  from the run's checkpoint) at epochs 149, 150, 250 and 251 equal to the
  JAX ``train/optim.py`` schedule's.

* At DSEC's frame (480x640, which the model resizes to 512x640), the
  resize of the inputs and of the output flow, and the IDS cameras
  (``sensor_size_divisor`` 32: a 16x20 parallel sensor) and their point
  transforms, against the JAX model's; and ``flagship.make_dsec_batch``'s
  form (sparse ``flow_2d``, ``flow_3d`` with a validity channel, no
  ``occ_mask_3d``) through the ``with_occ=False`` metric sums of both
  evaluators; and ``utils/flops.py : FlopCount.calls``, the kernel wrapper
  calls whose shapes phase 13 of ``chip_smoke.py`` holds each kernel at: one
  for each launch the bench counts on the card, on the CPU too.

Repaired on the way: the port's bilinear sampling raised an index error
for a NaN position (a random-weight forward on 48x64 frames diverges to
one), where the JAX package samples NaN; it now samples NaN too.

The l1 train step with sparse masks against the JAX ``make_train_step`` is
a case of tests/test_torch_train_step.py.
"""

import copy
import json
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from rpeflow_tpu_torch.flagship import DSEC_EVAL, make_dsec_batch, model_cfg
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from rpeflow_tpu_torch.train.config import ConfigNode, load_config
from synthetic_data import write_dsec, write_kubric
from torch_port_utils import small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINS = 2
N_POINTS = 64
N_SAMPLES = [32, 16]
#: DSEC sequences of the synthetic tree: two of the train split, two of the
#: val split (``data/dsec.py : TRAIN_SEQUENCE``), two frames each
DSEC_SEQS = ("thun_00_a", "zurich_city_02_c", "zurich_city_01_a", "zurich_city_09_a")
#: share of DSEC's ground-truth pixels set invalid, and their flow
INVALID = 0.2
INVALID_FLOW = -256.0
#: (dataset, eval entry point, with_occ, test config, training config)
CASES = {
    "dsec": ("eval_noocc", False, "conf/test/dsec.yaml", "conf/train/dsec.yaml"),
    "ekubric": ("eval_withocc", True, "conf/test/ekubric.yaml", "conf/train/ekubric.yaml"),
}
#: the sizes cut from the shipped configs (dotted keys, values)
SIZES = {"n_points": N_POINTS, "event_bins": BINS, "n_workers": 1}
MODEL_SIZES = {"model.n_samples": N_SAMPLES, "model.pwc2d.event_bins": BINS}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models run thousands of small operators,
    which many threads only slow down where other test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", module, *args, "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The synthetic DSEC and EKubric roots."""
    tmp = tmp_path_factory.mktemp("dsec_ekubric")
    dsec, kubric = str(tmp / "DSEC"), str(tmp / "ekubric")
    write_dsec(dsec, seqs=DSEC_SEQS, frames=2, bins=BINS)
    rng = np.random.RandomState(0)
    pre = os.path.join(dsec, "train_preprocess_pc")
    for seq in DSEC_SEQS:
        for name in sorted(os.listdir(os.path.join(pre, seq))):
            with h5py.File(os.path.join(pre, seq, name), "r+") as f:
                valid = rng.rand(*f["flow12_valid"].shape) >= INVALID
                flow = f["flow12"][...]
                flow[~valid] = INVALID_FLOW
                f["flow12_valid"][...] = valid
                f["flow12"][...] = flow
    # sequence 0 is EKubric's val split, 1 and 2 its train split
    write_kubric(kubric, n_seqs=3, frames=2, bins=BINS)
    return {"dsec": dsec, "ekubric": kubric}


def _eval_cfg(name, root, weights):
    """The shipped test config, its sizes cut and its data and weights set."""
    with open(os.path.join(REPO, CASES[name][2])) as f:
        cfg = yaml.safe_load(f)
    cfg["testset"].update(SIZES, root_dir=root)
    cfg["model"].update(batch_size=2, n_samples=N_SAMPLES)
    cfg["model"]["pwc2d"]["event_bins"] = BINS
    cfg["ckpt"]["path"] = weights
    return cfg


@pytest.fixture(scope="module", params=sorted(CASES))
def evaluated(request, trees, tmp_path_factory):
    """``(dataset, port metrics, JAX metrics)`` of one checkpoint."""
    name = request.param
    module, with_occ = CASES[name][:2]
    tmp = tmp_path_factory.mktemp(f"eval_{name}")
    weights = str(tmp / "weights.pt")
    cfg = _eval_cfg(name, trees[name], weights)
    model = seeded_init_(RPEFlow(ConfigNode(cfg["model"]), N_SAMPLES), seed=0)
    torch.save({"state_dict": model.state_dict()}, weights)
    cfg_path = str(tmp / "mini.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    proc = _run(f"rpeflow_tpu_torch.{module}", "--config", cfg_path, "--weights", weights)
    port = json.loads(proc.stdout.strip().splitlines()[-1])

    from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
    from rpeflow_tpu.train.evaluator import Evaluator

    ref = Evaluator(JaxConfigNode(cfg), with_occ=with_occ).run()
    return name, port, ref


def test_dsec_tree_has_sparse_ground_truth(trees):
    """The DSEC items the CLIs read carry invalid 2-D ground truth."""
    from rpeflow_tpu_torch.data import DSECPreprocessTrain

    cfg = _eval_cfg("dsec", trees["dsec"], None)["testset"]
    data = DSECPreprocessTrain(ConfigNode(cfg))
    assert len(data) == 4
    valid = np.stack([data[i]["flow_2d"][..., 2] for i in range(len(data))])
    assert 0.7 < valid.mean() < 0.9, valid.mean()
    assert "occ_mask_3d" not in data[0]


def test_eval_cli_reports_the_jax_evaluator_keys(evaluated):
    name, port, ref = evaluated
    assert port.keys() == ref.keys()
    noc = {k for k in port if k.endswith("_noc")}
    assert noc == (set() if name == "dsec" else {"EPE3d_noc", "5cm_noc", "10cm_noc"})
    for key, val in port.items():
        assert np.isfinite(val), key


def test_eval_cli_epe_matches_jax(evaluated):
    _, port, ref = evaluated
    for key in ("EPE2d", "EPE3d", "EPE3d_noc"):
        if key in ref:
            np.testing.assert_allclose(port[key], ref[key], rtol=1e-3, err_msg=key)


def test_eval_cli_percentages_match_jax(evaluated):
    _, port, ref = evaluated
    for key in ("1px", "Fl", "5cm", "10cm", "5cm_noc", "10cm_noc"):
        if key in ref:
            assert abs(port[key] - ref[key]) <= 0.5, (key, port[key], ref[key])


def _train_overrides(root, log_dir):
    """The overrides of a shipped training config: data roots, log.dir, one
    epoch, batch 2 and the sizes."""
    out = [f"{split}.{key}={val}" for split in ("trainset", "valset")
           for key, val in dict(SIZES, root_dir=root).items()]
    out += [f"{key}={json.dumps(val)}" for key, val in MODEL_SIZES.items()]
    return out + [f"log.dir={log_dir}", "training.max_epochs=1", "model.batch_size=2"]


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, trees, tmp_path_factory):
    """``(dataset, config as the trainer read it, its log)`` of one epoch
    of a shipped fine-tune config."""
    name = request.param
    log_dir = str(tmp_path_factory.mktemp(f"train_{name}") / "logs")
    overrides = _train_overrides(trees[name], log_dir)
    config = os.path.join(REPO, CASES[name][3])
    proc = _run("rpeflow_tpu_torch.train", "--config", config, "--overrides", *overrides)
    return name, load_config(config, overrides), proc.stderr


def test_fine_tune_trains_two_steps_and_validates(trained):
    _, cfg, log = trained
    assert cfg.model.loss2d.order == cfg.model.loss3d.order == "l1"
    steps = re.findall(r"E1 S(\d+) \[\d+/2\] loss: ([-\d.naif]+)", log)
    assert [s for s, _ in steps] == ["1", "2"], log[-2000:]
    assert all(np.isfinite(float(v)) for _, v in steps), steps
    assert "Validation:" in log and "New best" in log, log[-2000:]
    lrs = re.findall(r"E1 S\d+ .*, lr: ([\d.e+-]+),", log)
    assert lrs == ["1.00e-04", "1.00e-04"], lrs


@pytest.fixture(scope="module")
def resumed(trained, tmp_path_factory):
    """The trained run's optimizer as the trainer itself builds it:
    ``Trainer`` on the run's config, resuming from the run's
    ``epoch-001.pt`` (its steps per epoch from its own loader, its step
    count restored from the run)."""
    from rpeflow_tpu_torch.train.trainer import Trainer

    name, cfg, _ = trained
    cfg = copy.deepcopy(cfg)
    cfg.ckpt.path = os.path.join(cfg.log.dir, "epoch-001.pt")
    cfg.ckpt.resume = True
    cfg.log.dir = str(tmp_path_factory.mktemp(f"resume_{name}"))
    trainer = Trainer(cfg, device="cpu")
    return cfg, trainer


@pytest.mark.parametrize("epoch", [149, 150, 250, 251])
def test_fine_tune_learning_rate_follows_jax(resumed, epoch):
    """The trainer's optimizer (2 steps an epoch, 2 steps taken) against the
    JAX schedule at the first and the last step of the epoch (0-based, as
    both count ``step // steps_per_epoch``): 1e-4 before epoch 150, then
    halved at 150 and at 250."""
    from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
    from rpeflow_tpu.train.optim import make_lr_schedule as jax_schedule

    cfg, trainer = resumed
    opt = trainer.optimizer
    assert trainer.steps_per_epoch == 2
    assert trainer.curr_epoch == 2
    ref, unit = jax_schedule(JaxConfigNode(cfg.training.to_dict()), trainer.steps_per_epoch)
    assert unit == "epoch"
    want = 1e-4 * 0.5 ** ((epoch >= 150) + (epoch >= 250))
    step_count = opt.step_count
    assert step_count == 2
    try:
        for step in (2 * epoch, 2 * epoch + 1):
            opt.step_count = step
            np.testing.assert_allclose(opt.lr, float(ref(step)), rtol=1e-6)
            np.testing.assert_allclose(opt.lr, want, rtol=1e-6)
    finally:
        opt.step_count = step_count


def test_dsec_frame_resize_and_ids_cameras_match_jax():
    """480x640 -> 512x640 (images, event voxel), the 16x20 parallel sensor,
    perspective -> parallel and back for DSEC's camera, and the output flow
    resized from decode level 1 (128x160) to 480x640."""
    import jax.numpy as jnp

    from rpeflow_tpu import ops as jops
    from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
    from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
    from rpeflow_tpu_torch import ops

    h, w = DSEC_EVAL["h"], DSEC_EVAL["w"]
    batch = make_dsec_batch(0, 1, h, w, 256, 4, "cpu")
    np_batch = {k: v.numpy() for k, v in batch.items()}
    for key in ("images", "event_voxel"):
        x = batch[key].float()
        out = ops.resize_to_64x(x)
        assert tuple(out.shape) == (1, 512, 640, x.shape[-1])
        np.testing.assert_allclose(out.numpy(), np.asarray(jops.resize_to_64x(x.numpy())),
                                   atol=1e-4, err_msg=key)
    flow = np.random.RandomState(1).randn(1, 128, 160, 2).astype(np.float32)
    np.testing.assert_allclose(ops.resize_flow2d(torch.from_numpy(flow), h, w).numpy(),
                               np.asarray(jops.resize_flow2d(flow, h, w)), atol=1e-4)

    cfg = small_cfg_dict()
    persp, paral, decode = RPEFlow(ConfigNode(cfg), N_SAMPLES)._cameras(batch)
    jpersp, jparal, jdecode = JaxRPEFlow(cfgs=JaxConfigNode(cfg), n_samples_list=N_SAMPLES
                                         )._cameras(np_batch)
    assert (paral.sensor_h, paral.sensor_w) == (jparal.sensor_h, jparal.sensor_w) == (16, 20)
    assert (paral.cx, paral.cy) == (jparal.cx, jparal.cy) and decode is paral
    assert (persp.sensor_h, persp.sensor_w) == (jpersp.sensor_h, jpersp.sensor_w) == (h, w)
    pc = batch["pcs"][..., :3]
    out = ops.perspect2parallel(pc, persp, paral)
    ref = jops.perspect2parallel(jnp.asarray(np_batch["pcs"][..., :3]), jpersp, jparal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.parallel2perspect(out, persp, paral).numpy(), pc.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_dsec_batch_form_and_metric_sums_match_jax():
    """``make_dsec_batch``: the model's inputs, ``flow_2d`` with about 70%
    of its pixels valid, ``flow_3d`` with its validity channel at 1, no
    ``occ_mask_3d``; its ``with_occ=False`` metric sums (no ``3dnoc`` keys)
    equal the JAX evaluator's on the same predictions."""
    from rpeflow_tpu.train.evaluator import _metric_sums as jax_metric_sums
    from rpeflow_tpu_torch.train.evaluator import SUM_KEYS, _metric_sums

    b, h, w, n = 2, 48, 64, 128
    batch = make_dsec_batch(3, b, h, w, n, 20, "cpu", targets=True)
    assert sorted(batch) == sorted(("images", "pcs", "event_voxel", "intrinsics", "flow_2d",
                                    "flow_3d"))
    assert tuple(batch["flow_2d"].shape) == (b, h, w, 3)
    assert tuple(batch["flow_3d"].shape) == (b, n, 4)
    assert 0.6 < float(batch["flow_2d"][..., 2].mean()) < 0.8
    assert bool((batch["flow_3d"][..., 3] == 1).all())
    assert model_cfg("l1").loss2d.order == model_cfg("l1").loss3d.order == "l1"
    rng = np.random.RandomState(4)
    pred = {"flow_2d": torch.from_numpy(4 * rng.randn(b, h, w, 2).astype(np.float32)),
            "flow_3d": torch.from_numpy(0.1 * rng.randn(b, n, 3).astype(np.float32))}
    sums = _metric_sums(pred, batch, False)
    ref = jax_metric_sums({k: v.numpy() for k, v in pred.items()},
                          {k: v.numpy() for k, v in batch.items()}, False)
    assert tuple(sums) == SUM_KEYS and sorted(ref) == sorted(SUM_KEYS)
    assert float(sums["2d/counts"]) == float(batch["flow_2d"][..., 2].sum())
    for key in SUM_KEYS:
        np.testing.assert_allclose(float(sums[key]), float(ref[key]), rtol=1e-5, err_msg=key)


def test_flop_count_records_each_kernel_wrapper_call():
    """At five decode levels (DSEC's form, batch 1, 96x128, 512 points) the
    calls recorded in one eval forward and one fine-tune step are, kernel by
    kernel, the launches the bench counts on the card (``dwconv_bwd``
    launching the depthwise kernel); shapes are tuples of ints."""
    from rpeflow_tpu_torch.bench import EVAL_LAUNCHES, TRAIN_LAUNCHES
    from rpeflow_tpu_torch.flagship import dsec_training_cfg, n_samples
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step
    from rpeflow_tpu_torch.utils.flops import FlopCount

    model = seeded_init_(RPEFlow(model_cfg("l1"), n_samples(512, 5)), 0)
    batch = make_dsec_batch(5, 1, 96, 128, 512, 20, "cpu", targets=True)

    def calls(count):
        out = {}
        for name, shape in count.calls:
            assert all(isinstance(d, int) for d in shape), (name, shape)
            name = "dwconv" if name == "dwconv_bwd" else name
            out[name] = out.get(name, 0) + 1
        return out

    with torch.inference_mode(), FlopCount() as count:
        model({k: v for k, v in batch.items() if not k.startswith("flow")})
    assert calls(count) == {k: n for k, n in EVAL_LAUNCHES.items() if n}
    opt = optimizer_factory(dsec_training_cfg(), model.train(), steps_per_epoch=1)
    with FlopCount() as count:
        summary = train_step(model, opt, batch, torch.Generator().manual_seed(0))
    assert calls(count) == TRAIN_LAUNCHES
    assert np.isfinite(summary["loss"])


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_sampling_at_nan_and_inf_positions_matches_jax(padding_mode):
    """NaN, +inf and -inf positions sample what the JAX package samples (NaN,
    or a border pixel), with no index error; so does a warp by a flow with a
    NaN in it."""
    from rpeflow_tpu.ops import sample as jax_sample
    from rpeflow_tpu_torch.ops import sample

    rng = np.random.RandomState(6)
    feat = rng.randn(2, 5, 7, 3).astype(np.float32)
    xy = (rng.rand(2, 6, 2) * 9 - 1).astype(np.float32)
    xy[0, 1, 0], xy[0, 4, 1] = np.nan, np.nan
    xy[1, 2, 1], xy[1, 3, 0], xy[1, 5] = np.inf, -np.inf, np.nan
    out = sample.grid_sample_2d(torch.from_numpy(feat), torch.from_numpy(xy), padding_mode)
    ref = np.asarray(jax_sample.grid_sample_2d(feat, xy, padding_mode))
    assert np.isnan(ref).any()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, equal_nan=True)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    flow[1, 3, 2, 0] = np.nan
    out = sample.backwarp_2d(torch.from_numpy(feat), torch.from_numpy(flow), padding_mode)
    ref = np.asarray(jax_sample.backwarp_2d(feat, flow, padding_mode))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, equal_nan=True)
