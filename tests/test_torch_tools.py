"""The port's tools (``scripts/torch_*.py``) on the CPU at a tiny size.

Each tool runs in process with ``--device cpu`` (64x64 frames, 2 decode
levels, 256 points where it builds the model), and its results are checked:

* ``torch_bench_gather``: every variant equal to its plain version, then
  timed; the sweep;
* ``torch_repro_custom_call``: FINITE (exit 0) with the zero store's output
  discarded and added, and its graph equal (atol 1e-5) to the JAX script's
  (``conv``, ``dilated``, ``pallas_zero`` in interpret mode) on the same
  seeded input and weights;
* ``torch_bench_train_step``, ``torch_bench_breakdown``: every item timed,
  the step's summaries finite;
* ``torch_profile_forward``: category totals, module attribution (with the
  activation checkpoints' recomputed scopes and the backward's autograd
  nodes in a train step), the full table written to ``--out``;
* ``torch_bench_loader``: the voxelizers (native within 1e-6 of numpy) and
  items/s of a synthetic preprocessed DSEC sequence;
* ``torch_verify_checkpoint_parity``: on a synthetic FT3D split with a
  ``seeded_init_`` checkpoint in the upstream schema it exits 1 (random
  weights fail the README row), its metric table is the port's
  ``Evaluator.run()`` on the same config, and its rows and tolerances are
  the JAX script's;
* ``torch_quantify_eval_deviations``: ``metric_means`` equal (rtol 1e-6) to
  the JAX script's on the same numpy outputs and batch, the scene and its
  three subsample draws equal to the JAX script's, and every metric finite;
* ``torch_bench_knn1``: the four k = 1 formulations giving the indices of
  ``scripts/bench_knn1.py``'s four, then timed;
* ``torch_bench_convex``: variants B and C within 1e-5 of the JAX
  ``convex_upsample`` (``scripts/bench_convex.py`` runs its bench at import,
  so it is not imported), then timed;
* ``torch_conv3x3_probe``: the decoder's 55 conv calls of a path at a tiny
  frame, the plain version equal to ``F.conv2d``, with their sums.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from rpeflow_tpu_torch.train.config import ConfigNode
from synthetic_data import write_ft3d
from torch_port_utils import small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hw", "64", "64", "--points", "256", "--levels", "2"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models run thousands of small operators,
    which many threads only slow down where other test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(rel, name=None):
    spec = importlib.util.spec_from_file_location(
        name or os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_gather(capsys):
    tool = _load("scripts/torch_bench_gather.py")
    assert tool.main(["--device", "cpu", "--b", "2", "--n", "64", "--k", "2", "--c", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("equal to the plain version") == 4
    assert out.count("GB/s effective") == 4 and "the same kernel as C" in out
    assert tool.main(["sweep", "--device", "cpu", "--b", "1", "--n", "32", "--k", "2"]) == 0
    assert capsys.readouterr().out.count("ns/row") == 2 * len(tool.SWEEP)


@pytest.mark.parametrize("discard", [True, False])
def test_repro_custom_call_matches_the_jax_graph(discard, capsys):
    tool = _load("scripts/torch_repro_custom_call.py")
    jax_repro = _load("triage/repro_xla_custom_call.py", "jax_repro_xla_custom_call")
    argv = ["--device", "cpu", "--batch", "1", "--hw", "16", "24", "--channels", "4"]
    assert tool.main(argv + ([] if discard else ["--no-discard"])) == 0
    assert "FINITE" in capsys.readouterr().out

    rng = np.random.RandomState(0)
    x = rng.randn(1, 16, 24, 4).astype(np.float32)
    ws = [(rng.randn(3, 3, 4, 4) * (1.5 / np.sqrt(36))).astype(np.float32) for _ in range(8)]
    with pltpu.force_tpu_interpret_mode():
        y = jax_repro.conv(jax_repro.conv(jnp.asarray(x), ws[0]), ws[1])
        k = jax_repro.pallas_zero(y, 8)
        y = y + k if not discard else jax.lax.optimization_barrier((k, y))[1]
        for i, d in enumerate(tool.DILATIONS):
            y = jax_repro.dilated(y, ws[2 + i], d)
    with torch.no_grad():
        got = tool.graph(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [], 8, discard)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-4, atol=1e-5)


def test_bench_train_step(capsys):
    tool = _load("scripts/torch_bench_train_step.py")
    assert tool.main(TINY + ["--batch", "1", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "ms/step" in out and "finite=True" in out and "not measured" in out


def test_bench_breakdown():
    tool = _load("scripts/torch_bench_breakdown.py")
    res = tool.main(TINY + ["--batch", "1", "--iters", "1"])
    assert len(res) == 7 and all(np.isfinite(v) and v > 0 for v in res.values())


@pytest.mark.parametrize("train", [False, True])
def test_profile_forward(train, tmp_path, capsys):
    tool = _load("scripts/torch_profile_forward.py")
    out = tmp_path / "profile.tsv"
    res = tool.main(TINY + ["--batch", "1", "--runs", "1", "--top", "5", "--out", str(out)]
                    + (["--train"] if train else []))
    printed = capsys.readouterr().out
    assert len(res["categories"]) == 1 and res["busy_share"] == [] and res["kernels"] > 0
    cats = res["categories"][0]
    assert cats["cuDNN conv"] > 0 and cats["GEMM"] > 0 and cats["elementwise"] > 0
    assert "device busy: not measured (CPU run)" in printed
    rows = [line.split("\t") for line in out.read_text().splitlines()[2:]]
    modules = {r[3] for r in rows}
    assert any(m.startswith("pwc_fusion_core.") for m in modules)
    if train:  # the checkpointed blocks' recompute and the backward's nodes
        assert any(m.endswith("[recompute]") for m in modules)
        assert any(m.startswith("backward: ") for m in modules)
    else:
        assert not any(m.endswith("[recompute]") or m.startswith("backward: ") for m in modules)


def test_profile_forward_categories():
    tool = _load("scripts/torch_profile_forward.py")
    assert tool.category("void (anonymous namespace)::fps_kernel<32>(float const*)") == \
        "kernel fps"
    assert tool.category("(anonymous namespace)::sum_partials_kernel(float const*)") == \
        "kernel dwconv"
    assert tool.category("(anonymous namespace)::sum_partials(float const*)") == "kernel mdta_qkv"
    assert tool.category("Memcpy HtoD (Pageable -> Device)") == "memcpy/memset"
    assert tool.category("sm90_xmma_fprop_implicit_gemm_f32f32") == "cuDNN conv"
    assert tool.category("ampere_sgemm_128x64_nn") == "GEMM"
    assert tool.category("ampere_sgemm_128x64_nn", "aten::mm") == "GEMM"
    fft_gemm = "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8"
    assert tool.category(fft_gemm, "aten::cudnn_convolution") == "cuDNN conv"
    assert tool.category("void internal::region_transform_ABC_val<int, 32>",
                         "aten::convolution_backward") == "cuDNN conv"
    assert tool.category("void indexing_backward_kernel<float>", "aten::index_put_") == "other"
    assert tool.category("aten::mul") == "elementwise"
    assert tool.category("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert tool.category("void at::native::sbtopk::gatherTopK<float>") == "topk/sort"
    assert tool.category("void at::native::reduce_kernel<512, 1>") == "reduce"


def test_kernel_registry_names_every_global():
    """``_cuda.SOURCES`` lists each ``__global__`` function of each source
    (the profile tool finds the hand kernels by these names) and nothing
    else, and every launch key it names is counted."""
    import re

    from rpeflow_tpu_torch.ops import _cuda

    tool = _load("scripts/torch_profile_forward.py")
    names = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    assert sorted(p.name for p in _cuda.CSRC.glob("*.cu")) == sorted(_cuda.SOURCES)
    for src, kernels in _cuda.SOURCES.items():
        assert sorted(names.findall((_cuda.CSRC / src).read_text())) == sorted(kernels), src
        for fn, key in kernels.items():
            assert key in _cuda.LAUNCHES
            assert tool.category(f"void (anonymous namespace)::{fn}<1>(float*)") == f"kernel {key}"


def test_bench_loader(capsys):
    tool = _load("scripts/torch_bench_loader.py")
    assert tool.main(["--mode", "both", "--items", "2", "--events", "2000", "--hw", "48", "64",
                      "--points", "256", "--repeats", "1", "--workers", "1", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("native") == 2 and out.count("items/s") == 3


@pytest.fixture(scope="module")
def parity_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    root = tmp / "data"
    write_ft3d(str(root), "val", 2, h=64, w=64, n_pts=300, bins=2, seed=3)
    losses = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
    model = dict(small_cfg_dict(), batch_size=2, n_samples=[128, 64], loss2d=losses,
                 loss3d=losses)
    cfg = {"testset": {"name": "flyingthings3devent", "root_dir": str(root), "split": "val",
                       "n_workers": 1, "n_points": 256, "max_depth": 35.0, "event_bins": 2,
                       "event_polarity": True, "augmentation": {"enabled": False},
                       "n_resample": 1},
           "model": model, "ckpt": {"path": None, "strict": True}}
    cfg_path = tmp / "test.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    weights = tmp / "synthetic.pt"
    state = seeded_init_(RPEFlow(ConfigNode(model), (128, 64)), seed=0).state_dict()
    torch.save({"last_epoch": 0, "last_step": 0, "state_dict": state, "best_metrics": None},
               str(weights))
    return cfg, str(cfg_path), str(weights)


def test_verify_checkpoint_parity(parity_setup, capsys):
    from rpeflow_tpu_torch.train.evaluator import Evaluator

    cfg, cfg_path, weights = parity_setup
    tool = _load("scripts/torch_verify_checkpoint_parity.py")
    rc = tool.main(["--weights", weights, "--config", cfg_path, "--n-resample", "0",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert rc == 1 and report["pass"] is False  # random weights fail the README row
    assert report["device"] == "cpu"

    ref = Evaluator(ConfigNode(dict(cfg, ckpt={"path": weights, "strict": True})),
                    with_occ=True, device="cpu").run()
    expected = tool.EXPECTED["things"]["metrics"]
    assert set(report["metrics"]) == set(expected)
    for name, row in report["metrics"].items():
        assert row["expected"] == expected[name]
        assert row["got"] == round(ref[name], 4), name
        assert row["ok"] is (abs(ref[name] - expected[name]) <= row["tol"])


def test_verify_checkpoint_parity_keeps_the_jax_rows():
    tool = _load("scripts/torch_verify_checkpoint_parity.py")
    jax_tool = _load("scripts/verify_checkpoint_parity.py", "jax_verify_checkpoint_parity")
    assert tool.EXPECTED == jax_tool.EXPECTED
    assert (tool.EPE_2D_REL_TOL, tool.EPE_3D_REL_TOL, tool.PCT_ABS_TOL) == \
        (jax_tool.EPE_2D_REL_TOL, jax_tool.EPE_3D_REL_TOL, jax_tool.PCT_ABS_TOL)
    flags = {a.dest: a.default for a in tool.parser()._actions}
    assert flags.pop("device") == "cuda"
    for dest in ("benchmark", "config", "data_root", "max_batches", "n_resample", "batch_size",
                 "rel_tol_epe2d", "rel_tol_epe3d", "abs_tol_pct", "weights"):
        assert dest in flags, dest


@pytest.mark.parametrize("masked", [False, True])
def test_resample_metric_means_match_jax(masked):
    tool = _load("scripts/torch_quantify_eval_deviations.py")
    jax_tool = _load("scripts/quantify_eval_deviations.py", "jax_quantify_eval_deviations")
    rng = np.random.RandomState(5)
    b, h, w, n = 2, 12, 16, 64
    outputs = {"flow_2d": (rng.randn(b, h, w, 2) * 4).astype(np.float32),
               "flow_3d": (rng.randn(b, n, 3) * 0.1).astype(np.float32)}
    batch = {"flow_2d": (rng.randn(b, h, w, 2) * 4).astype(np.float32),
             "flow_3d": (rng.randn(b, n, 3) * 0.1).astype(np.float32)}
    if masked:  # validity channels, and a NaN prediction the masks drop
        batch["flow_2d"] = np.concatenate(
            [batch["flow_2d"], (rng.rand(b, h, w, 1) > 0.2).astype(np.float32)], -1)
        batch["flow_3d"] = np.concatenate(
            [batch["flow_3d"], (rng.rand(b, n, 1) > 0.3).astype(np.float32)], -1)
        outputs["flow_3d"][0, 3] = np.nan
    got = tool.metric_means(outputs, batch)
    want = jax_tool.metric_means(outputs, batch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_resample_study(capsys):
    import importlib

    tool = _load("scripts/torch_quantify_eval_deviations.py")
    graft = importlib.import_module("__graft_entry__")
    b, h, w, n = 1, 64, 64, 256
    want = graft._synth_batch(np.random.RandomState(1), b=b, h=h, w=w, n=2 * n, bins=10,
                              with_targets=True)
    subs = tool.resamples(b, h, w, n)
    assert len(subs) == 3
    for seed, sub in enumerate(subs):
        rs = np.random.RandomState(100 + seed)
        idx = np.stack([rs.choice(2 * n, n, replace=False) for _ in range(b)])
        for k, v in want.items():
            if k in ("pcs", "flow_3d"):
                v = np.take_along_axis(v, idx[..., None], axis=1)
            np.testing.assert_array_equal(sub[k], v, err_msg=k)
    res = tool.main(["--device", "cpu", "--h", "64", "--w", "64", "--n", "256", "--b", "1",
                     "--levels", "2"])
    out = capsys.readouterr().out
    assert "only on the TPU" in out and out.count("[resample seed") == 3
    assert len(res["forward_ms"]) == 3 and res["launches"] == {}
    assert all(np.isfinite(v) for m in res["per_seed"] for v in m.values())
    assert all(np.isfinite(v["spread"]) for v in res["spread"].values())


def test_bench_knn1_matches_the_jax_formulations(capsys):
    tool = _load("scripts/torch_bench_knn1.py")
    jax_tool = _load("scripts/bench_knn1.py", "jax_bench_knn1")
    inp, qry = tool.make_inputs(2, 512, 128, 2, grid=8)
    ti, tq = torch.from_numpy(inp), torch.from_numpy(qry)
    ji, jq = jnp.asarray(inp), jnp.asarray(qry)
    want = {"current (chunked matmul)": np.asarray(jax_tool.current(ji, jq))[..., 0],
            "broadcast full": np.asarray(jax_tool.broadcast_full(ji, jq)),
            "broadcast chunked": np.asarray(jax_tool.broadcast_chunked(ji, jq, chunk=128)),
            "matmul full": np.asarray(jax_tool.matmul_full(ji, jq))}
    assert [name for name, _ in tool.VARIANTS] == list(want)
    for name, fn in tool.VARIANTS:  # broadcast chunked: one chunk of 4320 at Q = 512
        np.testing.assert_array_equal(fn(ti, tq).numpy(), want[name], err_msg=name)
    np.testing.assert_array_equal(tool.broadcast_chunked(ti, tq, 128).numpy(),
                                  want["broadcast chunked"])
    res = tool.main(["--device", "cpu", "--b", "2", "--q", "512", "--n", "128"])
    assert capsys.readouterr().out.count(" ms  peak memory not measured") == 4
    assert all(r["match"] == 1.0 and np.isfinite(r["ms"]) for r in res.values())
    assert all(r["mismatches"] == 0 or 0 < r["max_gap"] < 1e-2 for r in res.values())


def test_bench_convex_matches_the_jax_upsampler(capsys):
    from rpeflow_tpu.ops.interp import convex_upsample as jax_convex_upsample
    from rpeflow_tpu_torch.ops.interp import convex_upsample

    tool = _load("scripts/torch_bench_convex.py")
    flow, mask = tool.make_inputs(2, 8, 12, 4, torch.device("cpu"))
    want = np.asarray(jax_convex_upsample(jnp.asarray(flow.numpy()), jnp.asarray(mask.numpy()),
                                          4))
    for fn in (tool.variant_b, tool.variant_c, convex_upsample):
        got = fn(flow, mask, 4).numpy()
        assert got.shape == want.shape == (2, 32, 48, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=fn.__name__)
    res = tool.main(["--device", "cpu", "--b", "1", "--h", "8", "--w", "12"])
    assert capsys.readouterr().out.count("max err") == 2
    assert all(r["max_abs_err"] < 1e-5 and np.isfinite(r["ms"]) for r in res.values())


@pytest.mark.parametrize("path", ["ft3d", "dsec"])
def test_conv3x3_probe(path, capsys):
    tool = _load("scripts/torch_conv3x3_probe.py")
    report = tool.main(["--device", "cpu", "--hw", "64", "64", "--runs", "1", "--paths", path,
                        "--f64"])
    sums = report["paths"][path]["sums"]
    assert sums["calls"] == 55 and sums["max_err"] == 0.0 and sums["bitwise_equal"]
    assert np.isfinite(sums["ms"]) and sums["bound_ms"] > 0
    recs = report["paths"][path]["shapes"]
    assert {r["level"] for r in recs} == {1, 2, 3, 4, 5}
    assert all(r["err_f64"] < 1e-5 for r in recs if "err_f64" in r)
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["conv3x3"][path]["calls"] == 55
