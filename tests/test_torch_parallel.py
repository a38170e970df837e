"""Data parallelism of the port (``rpeflow_tpu_torch.parallel``): two gloo
ranks on the CPU against one process on the concatenated batch.

The ranks run in processes of ``parallel.dryrun.spawn_ranks`` (bodies in
tests/torch_dp_worker.py); the one-process reference runs here. Model and
batch are those of tests/test_torch_model.py (64x64, 64 points,
n_samples (32, 16): 2 decode levels, k = 8), batch 2 = one sample a rank.

Bounds:

* ``all_reduce_sum``: forward and backward equal to the one-process sums
  (rtol 1e-6);
* ``batch_norm``: output, input gradient and running buffers rtol 1e-5
  (atol 1e-6; read: PERF.md, PR 8);
* one train step, MI on, with valid masks that differ between the ranks
  (2-D: 90% and 30% of the pixels, 3-D: 80% and 40% of the points): loss
  and every summary value rtol 1e-5; every parameter after the step within
  1e-5 of its leaf's largest entry; the gradients within the per-leaf bound
  of tests/test_torch_train_step.py; batch-norm buffers rtol 1e-5 (atol
  1e-7); the two ranks' parameters bitwise equal. The step is SGD: Adam's
  first update is ~lr sign(g) and would turn the sum-order noise of
  near-zero gradients (the pre-norm biases' exact gradient is 0) into
  differences of 2 lr. The reference replays the ranks' discrete choices
  (``chip_smoke.shared_choices``), its own differing in at most
  ``chip_smoke.REPLAY_BOUND`` of them. Negative control: the mean of the
  per-rank masked means differs from the global loss by more than the
  loss's tolerance;
* the evaluator over 2 ranks on 5 samples at global batch 4 (rank 1's
  slice of the last batch is empty): metric totals rtol 1e-6.
"""

import copy
import os
import re
import socket
from contextlib import nullcontext

import numpy as np
import pytest
import torch
import yaml

import torch_dp_worker
from chip_smoke import REPLAY_BOUND, pre_norm_biases, shared_choices
from rpeflow_tpu_torch.model import RPEFlow, rpeflow, seeded_init_
from rpeflow_tpu_torch.nn.layers import batch_norm
from rpeflow_tpu_torch.parallel import mesh
from rpeflow_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.state import train_step
from synthetic_data import write_ft3d
from torch_port_utils import make_inputs, small_cfg_dict

N_SAMPLES = (32, 16)
LOSS = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
SGD = {"max_epochs": 10, "optimizer": "sgd",
       "lr": {"scheduler": "MultiStepLR", "init_value": 1e-4, "momentum": 0.9,
              "decay_rate": 0.5, "decay_milestones": [5]},
       "weight_decay": 1e-6, "bias_decay": 0.0}
WORLD = 2


def _ranks(fn, tmp_path, *args):
    """Run ``fn(*args, out)`` on ``WORLD`` gloo ranks; their results."""
    out = str(tmp_path)
    spawn_ranks(fn, WORLD, *args, out)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(WORLD)]


# -- all_reduce_sum and batch_norm -------------------------------------------------


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("units")
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    spec = {"x": t(WORLD, 3, 5), "w": t(WORLD, 3, 5), "images": 2 + t(4, 6, 7, 8),
            "g": t(4, 6, 7, 8), "bn_weight": 1 + 0.1 * t(8), "bn_bias": 0.1 * t(8)}
    path = str(tmp / "spec.pt")
    torch.save(spec, path)
    return spec, _ranks(torch_dp_worker.all_reduce_and_batch_norm, tmp, path)


def test_all_reduce_sum_forward_and_backward(units):
    """Forward: the sum of the ranks' tensors on every rank. Backward of
    ``sum_r <y, w_r>``: every rank's ``x`` gets ``sum_r w_r``."""
    spec, ranks = units
    for res in ranks:
        np.testing.assert_allclose(res["sum"], spec["x"].sum(0), rtol=1e-6)
        np.testing.assert_allclose(res["sum_grad"], spec["w"].sum(0), rtol=1e-6)
        # and one batch_norm call after it: one all-reduce each way
        assert res["collectives"] == {"test": 1, "test (backward)": 1, "batch_norm": 1,
                                      "batch_norm (backward)": 1}


def test_batch_norm_over_ranks_matches_one_process(units):
    spec, ranks = units
    bn = torch.nn.BatchNorm2d(8).train()
    with torch.no_grad():
        bn.weight.copy_(spec["bn_weight"])
        bn.bias.copy_(spec["bn_bias"])
    x = spec["images"].clone().requires_grad_()
    out = batch_norm(bn, x)
    (out * spec["g"]).sum().backward()
    n = x.shape[0] // WORLD
    worst = [max(float((res[key] - want[r * n:(r + 1) * n]).abs().max())
                 for r, res in enumerate(ranks))
             for key, want in (("bn_out", out.detach()), ("bn_input_grad", x.grad))]
    worst.append(float((ranks[0]["running_var"] - bn.running_var).abs().max()))
    print("batch_norm over 2 ranks, largest |d| of the output, input gradient, running var: "
          + ", ".join(f"{w:.2e}" for w in worst))
    for r, res in enumerate(ranks):
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["bn_out"], out[rows].detach(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["bn_input_grad"], x.grad[rows], rtol=1e-5, atol=1e-6)
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(res[key], getattr(bn, key), rtol=1e-5, atol=1e-6)
    # a parameter's gradient is the sum of the ranks' (all_reduce_grads averages
    # the ranks' gradients of their share of a global mean)
    for key, param in (("bn_weight_grad", bn.weight), ("bn_bias_grad", bn.bias)):
        np.testing.assert_allclose(ranks[0][key] + ranks[1][key], param.grad, rtol=1e-5,
                                   atol=1e-5)


# -- one train step ---------------------------------------------------------------


def _uneven_batch():
    """make_inputs' batch of 2, its masks kept on 90% / 30% of the pixels and
    80% / 40% of the points (validity channels of flow_2d and flow_3d)."""
    batch = make_inputs(0, targets=True)
    rng = np.random.RandomState(5)
    batch["flow_2d"][..., 2] = rng.rand(2, 64, 64) < np.float32([0.9, 0.3])[:, None, None]
    keep_3d = rng.rand(2, 64) < np.float32([0.8, 0.4])[:, None]
    batch["flow_3d"] = np.concatenate([batch["flow_3d"], keep_3d[..., None]], -1)
    batch.pop("occ_mask_3d")
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _merge(tapes):
    """The ranks' recorded choices as one process on the whole batch makes
    them: rows in rank order, and for the two frames' stacked searches
    (leading axis 2 x the local batch) each frame's rows in rank order."""
    merged = []
    for ts in zip(*tapes):
        assert len({t.shape for t in ts}) == 1, [t.shape for t in ts]
        if ts[0].shape[0] == 1:
            merged.append(torch.cat(ts))
        else:
            assert ts[0].shape[0] == 2, ts[0].shape
            merged.append(torch.cat([t[:1] for t in ts] + [t[1:] for t in ts]))
    return merged


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """``(ranks' results, reference summary, reference model, replay counts,
    batch, cfg)``."""
    tmp = tmp_path_factory.mktemp("steps")
    cfg = dict(small_cfg_dict(), loss2d=LOSS, loss3d=LOSS)
    model = seeded_init_(RPEFlow(ConfigNode(cfg), N_SAMPLES), seed=1).train()
    batch = _uneven_batch()
    spec = {"cfg": cfg, "n_samples": N_SAMPLES, "state": model.state_dict(), "batch": batch,
            "training": SGD, "seed": 3, "mi": True}
    path = str(tmp / "spec.pt")
    torch.save(spec, path)
    ranks = _ranks(torch_dp_worker.train_step, tmp, path)

    opt = optimizer_factory(ConfigNode(SGD), model, steps_per_epoch=10)
    with shared_choices(_merge([r["tape"] for r in ranks]), replay=True) as counts:
        ref = train_step(model, opt, batch, torch.Generator().manual_seed(3), compute_mi=True)
    return ranks, ref, model, counts, batch, cfg


def test_replayed_choices_are_near_the_references_own(steps):
    counts = steps[3]
    for kind, (differ, total) in counts.items():
        assert total > 0 and differ <= REPLAY_BOUND[kind] * total, (kind, differ, total)


def test_train_step_loss_and_summary_match_one_process(steps):
    ranks, ref = steps[:2]
    assert ref["mi_loss"] != 0.0
    print("train step, 2 ranks vs 1 process, largest relative |d| of a summary value: "
          "%.2e" % max(abs(r["summary"][k] - v) / abs(v)
                       for r in ranks for k, v in ref.items() if v))
    for res in ranks:
        assert res["summary"].keys() == ref.keys()
        for key, val in ref.items():
            np.testing.assert_allclose(res["summary"][key], val, rtol=1e-5, err_msg=key)


def test_train_step_parameters_and_gradients_match_one_process(steps):
    ranks, _, model = steps[:3]
    zero_grad = pre_norm_biases(model)
    print("train step, 2 ranks vs 1 process, largest parameter |d| over its leaf's largest "
          "entry: " + "%.2e" % max(float((ranks[0]["params"][k] - p.detach()).abs().max())
                                  / float(p.detach().abs().max())
                                  for k, p in model.named_parameters()))
    for name, p in model.named_parameters():
        got = ranks[0]["params"][name]
        scale = float(p.detach().abs().max())
        assert float((got - p.detach()).abs().max()) <= 1e-5 * scale, name
        if p.grad is None or name in zero_grad:
            continue
        d = float((ranks[0]["grads"][name] - p.grad).abs().max())
        assert d <= 2e-3 * max(float(p.grad.abs().max()), 1.0) + 1e-4, (name, d)


def test_train_step_batch_norm_buffers_match_one_process(steps):
    ranks, _, model = steps[:3]
    keys = [k for k, _ in model.named_buffers() if k.endswith(("running_mean", "running_var"))]
    assert keys
    for key, buf in model.named_buffers():
        for res in ranks:
            np.testing.assert_allclose(res["buffers"][key], buf, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


def test_train_step_leaves_ranks_bitwise_equal(steps):
    ranks = steps[0]
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    for name, b in ranks[0]["buffers"].items():
        assert torch.equal(b, ranks[1]["buffers"][name]), name
    # one all-reduce per batch-norm call and one in its backward, one for each
    # loss's mask counts, one of the gradients, one of the summary; two
    # broadcasts (float32 parameters and buffers, int64 batch counters)
    counts = dict(ranks[0]["collectives"])
    n_bn = counts.pop("batch_norm")
    assert n_bn > 0 and counts.pop("batch_norm (backward)") == n_bn, ranks[0]["collectives"]
    assert counts == {"replicate": 2, "loss mask counts": 2, "gradients": 1,
                      "train summary": 1}, counts


def test_naive_mean_of_rank_losses_is_told_apart(steps, monkeypatch):
    """Negative control: each rank's own masked means, averaged over the
    ranks, differ from the global loss by more than the loss's tolerance."""
    _, _, _, _, batch, cfg = steps
    model = seeded_init_(RPEFlow(ConfigNode(cfg), N_SAMPLES), seed=1).train()
    losses = {}
    for name, split in (("global", False), ("naive", True)):
        if split:
            for key in ("supervised_loss_2d", "supervised_loss_3d"):
                monkeypatch.setattr(rpeflow, key, _per_sample_mean(getattr(rpeflow, key)))
        with torch.no_grad():
            _, aux = copy.deepcopy(model)(batch, compute_loss=True)
        losses[name] = {k: float(aux["scalar_summary"][k]) for k in ("loss_2d", "loss_3d")}
    print(f"global {losses['global']}, mean of the per-rank masked means {losses['naive']}")
    for key, glob in losses["global"].items():
        assert abs(losses["naive"][key] - glob) > 1e-5 * abs(glob), (key, losses)


def _per_sample_mean(loss_fn):
    """``loss_fn`` on each sample alone (one rank's own masked means),
    averaged over the samples."""
    def mean(flows, target, cfg, *indices):
        return sum(loss_fn([f[i:i + 1] for f in flows], target[i:i + 1], cfg,
                           *[[ix[i:i + 1] for ix in idx] for idx in indices])
                   for i in range(WORLD)) / WORLD
    return mean


# -- evaluation -------------------------------------------------------------------


def test_evaluator_over_two_ranks_matches_one_process(tmp_path):
    from rpeflow_tpu_torch.train.evaluator import Evaluator

    root = str(tmp_path / "data")
    write_ft3d(root, "val", 5, h=64, w=64, n_pts=100, bins=2, seed=1)
    weights = str(tmp_path / "weights.pt")
    model_cfg = dict(small_cfg_dict(), batch_size=4, n_samples=list(N_SAMPLES))
    torch.save({"state_dict": seeded_init_(RPEFlow(ConfigNode(model_cfg), N_SAMPLES),
                                            seed=0).state_dict()}, weights)
    cfg = {"testset": {"name": "flyingthings3devent", "root_dir": root, "split": "val",
                       "n_workers": 1, "n_points": 64, "max_depth": 35.0, "event_bins": 2,
                       "event_polarity": True, "augmentation": {"enabled": False},
                       "n_resample": 1},
           "model": model_cfg, "ckpt": {"path": weights, "strict": True}}
    cfg_path = str(tmp_path / "eval.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ranks = _ranks(torch_dp_worker.evaluate, tmp_path, cfg_path)

    ref, times = {}, []
    Evaluator(ConfigNode(cfg), with_occ=True, device="cpu")._run_round(ref, times)
    print("evaluator, 2 ranks vs 1 process, largest relative |d| of a total: %.2e" % max(
        abs(r["totals"][k] - v) / abs(v) for r in ranks for k, v in ref.items() if v))
    assert len(times) == 2 and [r["n_timed"] for r in ranks] == [2, 1]
    for res in ranks:
        assert res["totals"].keys() == ref.keys()
        assert res["collectives"] == {"metric sums": 2}
        for key, val in ref.items():
            np.testing.assert_allclose(res["totals"][key], val, rtol=1e-6, err_msg=key)
    assert ref["2d/counts"] > 0 and ref["3d/counts"] > 0


# -- the trainer ------------------------------------------------------------------


def test_trainer_over_two_ranks_matches_one_process(tmp_path):
    """The training CLI under a 2-rank group against one process, on 4
    training samples (2 steps of 2) and 3 validation samples (a full batch
    split over the ranks, then a short one that each rank evaluates whole).
    The learning rate is 0: the steps' gradients are held by the train step
    tests above, and with fixed weights the validation is the same forward
    on both sides. Checked: rank 0 alone logs the 2 steps and writes the
    checkpoints; the batch statistics the steps moved (rtol 1e-5, atol
    1e-7) and the validation metrics of ``best.pt`` (rtol 1e-5) equal the
    one process's."""
    import subprocess
    import sys

    from test_torch_train_cli import REPO, _cfg

    root = str(tmp_path / "data")
    write_ft3d(root, "train", 4, h=64, w=64, n_pts=100, bins=2, seed=0)
    write_ft3d(root, "val", 3, h=64, w=64, n_pts=100, bins=2, seed=1)
    paths = {}
    for name in ("ranks", "one"):
        cfg = _cfg(root, str(tmp_path / name))
        cfg["training"]["lr"]["init_value"] = 0.0
        paths[name] = str(tmp_path / f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    ranks = _ranks(torch_dp_worker.trainer, tmp_path, paths["ranks"])
    proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.train", "--config",
                           paths["one"], "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    with open(tmp_path / "ranks" / "train.log") as f:
        log = f.read()
    assert "Data parallel over 2 rank(s), 1 samples each" in log
    assert [int(s) for s in re.findall(r"E1 S(\d+) \[\d+/2\]", log)] == [1, 2], log[-2000:]
    # per step a gradient and a summary all-reduce; per validation batch a
    # summary one; a barrier after each checkpoint (best, epoch-001)
    for res in ranks:
        counts = res["collectives"]
        assert [counts[k] for k in ("gradients", "train summary", "eval summary", "barrier")] \
            == [2, 2, 2, 2], counts
    # the same files, one TensorBoard event file among them (rank 0's)
    files = [sorted(n.split(".tfevents")[0] for n in os.listdir(tmp_path / name))
             for name in ("ranks", "one")]
    assert files[0] == files[1], files
    got, want = (torch.load(tmp_path / name / "best.pt", map_location="cpu", weights_only=True)
                 for name in ("ranks", "one"))
    for key, val in want["best_metrics"].items():
        np.testing.assert_allclose(got["best_metrics"][key], val, rtol=1e-5, err_msg=key)
    for key, val in want["state_dict"].items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state_dict"][key], val, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        else:
            assert torch.equal(got["state_dict"][key], val), key


# -- the dryrun and the process group --------------------------------------------


def test_dryrun_multichip_two_ranks(capfd):
    dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capfd.readouterr().out


def test_no_environment_means_no_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    mesh.reset_collective_counts()
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    x = torch.ones(3, requires_grad=True)
    assert mesh.all_reduce_sum(x, "test") is x
    assert torch.equal(mesh.shard_batch({"a": x})["a"], x)
    mesh.all_reduce_grads(torch.nn.Linear(2, 2))
    assert mesh.COLLECTIVES == {}


def test_a_group_that_cannot_be_joined_raises(monkeypatch):
    """An environment naming 2 ranks whose rendezvous port is taken: rank 0
    cannot listen there, and the call raises instead of running alone."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(taken.getsockname()[1]))
        with pytest.raises(RuntimeError, match="could not join"):
            mesh.maybe_initialize_distributed("cpu")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="incomplete torchrun environment"):
        mesh.maybe_initialize_distributed("cpu")
    assert not mesh.is_distributed()


# -- each kernel launches on its input's device -----------------------------------


def test_wrappers_launch_on_their_inputs_device(monkeypatch):
    """With the kernel library, the device guard, the current device and the
    stream lookup stubbed, each wrapper called on tensors of another device
    than the current one (``meta`` here) makes that device current and
    launches on that device's stream."""
    from rpeflow_tpu_torch.ops import _cuda, correlation, dwconv, fps, gather, gdfn, mdta
    from rpeflow_tpu_torch.ops import zero_store

    guarded, streams, launched = [], [], []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append(name) or 0

    def device_guard(device):
        guarded.append(device)
        return nullcontext()

    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_cuda, "stream", lambda device: streams.append(device) or 0)
    monkeypatch.setattr(_cuda, "lib", Lib)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *args, **kwargs: None)
    monkeypatch.setattr(_cuda, "sm_count", lambda device: 132)
    monkeypatch.setattr(_cuda, "LAUNCHES", dict.fromkeys(_cuda.LAUNCHES, 0))
    dev = torch.device("meta")
    x = torch.empty(2, 8, 16, 32, device=dev)
    calls = {
        "rpeflow_fps": lambda: fps.furthest_point_sampling(torch.empty(2, 64, 3, device=dev),
                                                           16),
        "rpeflow_correlation2d": lambda: correlation.correlation2d_fwd(x, x, 4),
        "rpeflow_correlation2d_bwd": lambda: correlation.correlation2d_bwd(
            x, x, torch.empty(2, 8, 16, 81, device=dev), 4),
        "rpeflow_mdta_qkv": lambda: mdta.mdta_qkv(x, x, torch.empty(4, 32, device=dev),
                                                  torch.empty(3, 3, 96, device=dev), 3),
        "rpeflow_gdfn": lambda: gdfn.gdfn_fwd(x, torch.empty(32, 170, device=dev),
                                              torch.empty(3, 3, 170, device=dev),
                                              torch.empty(85, 32, device=dev)),
        "rpeflow_dwconv": lambda: dwconv.dwconv_fwd(x, torch.empty(3, 3, 32, device=dev)),
        "rpeflow_dwconv_bwd": lambda: dwconv.dwconv_bwd(x, x, torch.empty(3, 3, 32,
                                                                          device=dev)),
        "rpeflow_gather_rows": lambda: gather.gather_rows(
            torch.empty(2, 64, 8, device=dev), torch.empty(2, 32, dtype=torch.int32, device=dev)),
        "rpeflow_gather_lanes": lambda: gather.gather_lanes(
            torch.empty(2, 8, 64, device=dev), torch.empty(2, 32, dtype=torch.int64, device=dev)),
        "rpeflow_zero_store": lambda: zero_store.zero_store(x, 4),
    }
    for name, call in calls.items():
        guarded.clear(), streams.clear(), launched.clear()
        call()
        assert launched == [name] and guarded == [dev] and streams == [dev], (
            name, launched, guarded, streams)


def test_launch_guard_follows_the_calling_threads_current_device(monkeypatch):
    """``_cuda.on_device`` enters the device guard only where the operands'
    device is not the calling thread's current one: a thread whose current
    device is 0 launching on ``cuda:1`` makes ``cuda:1`` current, the main
    thread, whose current device is 1, launches there without the guard;
    both on ``cuda:1``'s stream. (The current device is per thread in the
    CUDA runtime; stubbed here per thread.)"""
    import threading

    from rpeflow_tpu_torch.ops import _cuda

    current = threading.local()
    guarded, streams = [], []

    def device_guard(device):
        guarded.append((threading.current_thread().name, device))
        return nullcontext()

    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current.index)
    monkeypatch.setattr(_cuda, "stream", lambda device: streams.append(device) or 7)
    dev = torch.device("cuda", 1)

    def launch(index):
        current.index = index
        with _cuda.on_device(dev) as stream:
            assert stream == 7

    launch(1)
    assert guarded == [] and streams == [dev]
    worker = threading.Thread(target=launch, args=(0,), name="launcher")
    worker.start()
    worker.join()
    assert guarded == [("launcher", dev)] and streams == [dev, dev]
