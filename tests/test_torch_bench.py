"""The port's bench (``python -m rpeflow_tpu_torch.bench``) on the CPU, at a
tiny size: 64x64 images, 256 points, 2 decode levels, the small config of
tests/torch_port_utils.py, batch 1, one intra-op thread.

* The bench's eval forward (its ``Runner``) with JAX weights carried over
  through ``compat.load_jax_variables`` against the JAX package's forward
  on the same numpy inputs, under tests/test_wrapper_parity.py's tolerance
  model.
* The FLOP count (``utils/flops.py``): a conv, grouped or not, with its
  gradients, the products, and one call of each model kernel's wrapper
  equal their closed forms written out here; the tiny forward's count is
  the same when the wrappers run their plain versions and when they hand
  back results with no product run inside them (as a kernel does); a train
  step counts more than twice the forward.
* The metric line's keys, units, ``value`` and ``mfu``; the refusals (an
  ``mfu`` over 1.05, a non-finite output, a step that moved nothing, a
  kernel launched fewer times than its path's count) each make the bench
  exit 1 with no metric line; ``bench.parse_output`` (which chip_smoke.py
  phase 12 and scripts/torch_bench_spread.py read a run with) checks one.
* Both workloads measured and traced at the tiny size on the CPU (the
  plain versions: no launch counted).
* ``python -m rpeflow_tpu_torch.bench`` with no card exits 2 with its
  message (whether there is a card is decided in the test).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
from rpeflow_tpu_torch import bench
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.ops import conv3x3, correlation, dwconv, fps, gdfn, mdta
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.utils.flops import FlopCount
from torch_port_utils import assert_flow_close, fill_variables, make_inputs, small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
TINY = dict(b=1, h=64, w=64, n=256, event_ch=4)
SAMPLES = (128, 64)
CPU = torch.device("cpu")


def tiny(name, **kw):
    return dataclasses.replace(bench.WORKLOADS[name], shape=TINY, levels=len(SAMPLES), **kw)


def tiny_cfg():
    return ConfigNode(dict(small_cfg_dict(), loss2d=LOSS, loss3d=LOSS))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the bench's forward against the JAX package ------------------------------


def test_bench_forward_matches_jax():
    cfg = small_cfg_dict()
    batch = make_inputs(0, b=1, n=256)
    model_in = {k: batch[k] for k in bench.MODEL_KEYS}
    jax_model = JaxRPEFlow(cfgs=JaxConfigNode(cfg), n_samples_list=SAMPLES)
    shapes = jax.eval_shape(
        lambda x: jax_model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                                 x, train=True, compute_mi=True), model_in)
    variables = fill_variables(shapes, seed=3)
    ref, _ = jax.jit(lambda v, x: jax_model.apply(v, x, train=False, compute_mi=False))(
        variables, {k: jnp.asarray(v) for k, v in model_in.items()})

    runner = bench.Runner(False, CPU, ConfigNode(cfg), SAMPLES, seed=0)
    load_jax_variables(runner.model, variables, strict=True)
    out = runner({k: torch.from_numpy(v) for k, v in model_in.items()})
    for key in ("flow_2d", "flow_3d"):
        assert np.isfinite(out[key].numpy()).all()
        assert_flow_close(out[key].numpy(), np.asarray(ref[key]),
                          f"bench forward {key} (64x64, 256 points, 2 decode levels)")


# -- the FLOP count ------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("grads", [(), ("x",), ("x", "w")])
def test_flop_count_of_a_conv(groups, grads):
    """2 * Cin/g * Cout * kh * kw * Hout * Wout * B forward, as much again
    for each gradient asked for."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 10, 12, generator=g, requires_grad=True)
    w = torch.randn(16, 8 // groups, 3, 3, generator=g, requires_grad=True)
    forward = 2 * (8 // groups) * 16 * 3 * 3 * 10 * 12 * 2
    with FlopCount() as count:
        y = F.conv2d(x, w, padding=1, groups=groups)
        if grads:
            torch.autograd.grad(y, [{"x": x, "w": w}[k] for k in grads], torch.ones_like(y))
    assert count.total == forward * (1 + len(grads))


@pytest.mark.parametrize("case", ["matmul", "einsum", "linear", "linear_backward"])
def test_flop_count_of_products(case):
    """2 * M * N * K a product; a bias is not counted; a linear's backward
    counts its input and weight gradients' products."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 4, 5, generator=g)
    b = torch.randn(3, 5, 6, generator=g)
    w = torch.randn(6, 5, generator=g, requires_grad=True)
    with FlopCount() as count:
        if case == "matmul":
            torch.matmul(a, b[0])
        elif case == "einsum":
            torch.einsum("bik,bkj->bij", a, b)
        else:
            y = F.linear(a, w, torch.ones(6))
            if case == "linear_backward":
                torch.autograd.grad(y, w, torch.ones_like(y))
    assert count.total == 2 * 3 * 4 * 5 * 6 * (2 if case == "linear_backward" else 1)


def _kernel_calls():
    """(name, call, closed-form FLOPs) of one call of each model kernel's
    wrapper: x [1, 6, 7, 8] (42 pixels, C = 8), d = 4 (81 shifts)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 7, 8, generator=g)
    xyz = torch.randn(2, 50, 3, generator=g)
    ln = torch.ones(4, 8)
    p, c = 42, 8
    return {
        "fps": (lambda: fps.furthest_point_sampling(xyz, 10), 8 * 2 * 50 * 10),
        "correlation2d": (lambda: correlation.correlation2d_fwd(x, x, 4), 2 * 81 * c * p),
        "correlation2d_bwd": (lambda: correlation.correlation2d_bwd(
            x, x, torch.ones(1, 6, 7, 81), 4), 2 * 2 * 81 * c * p),
        # q, k, v taps (3 x 3 on 3C) and the Gram q^T k
        "mdta_qkv": (lambda: mdta.mdta_qkv(x, x, ln, torch.ones(3, 3, 24), 3),
                     p * (2 * 9 * 3 * c + 2 * c * c)),
        # x @ w_in [8, 10], g @ w_out [5, 8], once each; 3 x 3 taps on 10 channels
        "gdfn": (lambda: gdfn.gdfn_fwd(x, torch.ones(8, 10), torch.ones(3, 3, 10),
                                       torch.ones(5, 8)),
                 p * (2 * 8 * 10 + 2 * 5 * 8 + 2 * 9 * 10)),
        "dwconv": (lambda: dwconv.dwconv_fwd(x, torch.ones(3, 3, 8)), 2 * 9 * p * c),
        "dwconv_bwd": (lambda: dwconv.dwconv_bwd(x, x, torch.ones(3, 3, 8)), 2 * 2 * 9 * p * c),
        "dwconv_bwd input only": (lambda: dwconv.dwconv_bwd(x, x, torch.ones(3, 3, 8),
                                                            need_dtaps=False), 2 * 9 * p * c),
        # 9 C products a pixel for each of 12 output channels
        "conv3x3": (lambda: conv3x3.conv3x3_fwd(x, torch.ones(12, 8, 3, 3), torch.ones(12), 2),
                    2 * 9 * c * 12 * p),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_flop_count_of_a_kernel_call(name):
    """A wrapper's call counts its formula, and none of the products its
    plain version runs (GDFN's two products once, not as 3xTF32 passes)."""
    call, flops = _kernel_calls()[name]
    with FlopCount() as count:
        call()
    assert count.total == flops
    assert count.kernels == {name.split()[0]: flops}


#: the module global each wrapper calls for a CPU tensor
PLAIN = [(fps, "furthest_point_sampling_plain"), (correlation, "correlation2d_plain"),
         (mdta, "mdta_qkv_plain"), (gdfn, "gdfn_plain"), (dwconv, "dwconv_plain"),
         (conv3x3, "conv3x3_plain")]


def _clone(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


def test_flop_count_same_on_kernel_and_plain_route(monkeypatch):
    """The tiny forward counted twice: with the wrappers running their plain
    versions (whose products run inside them), and with each wrapper
    handing back the first run's result with no product run inside it, as
    a kernel launch does. Same count, same kernel part, same outputs."""
    runner = bench.Runner(False, CPU, tiny_cfg(), SAMPLES, seed=0)
    batch = bench.make_batches(tiny("ft3d_eval"), CPU, 0, 1)[0]
    tape = []

    def recording(fn):
        def plain(*args, **kwargs):
            tape.append(_clone(fn(*args, **kwargs)))
            return _clone(tape[-1])
        return plain

    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, recording(getattr(mod, name)))
    with FlopCount() as plain_route:
        out_plain = runner(batch)
    replay = iter(tape)
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, lambda *args, **kwargs: _clone(next(replay)))
    with FlopCount() as kernel_route:
        out_kernel = runner(batch)

    assert next(replay, None) is None and len(tape) > 0
    assert plain_route._excluded > 0 and kernel_route._excluded == 0
    assert kernel_route.total == plain_route.total
    assert kernel_route.kernels == plain_route.kernels
    assert set(plain_route.kernels) == {"fps", "correlation2d", "mdta_qkv", "gdfn", "dwconv",
                                        "conv3x3"}
    assert plain_route.total > sum(plain_route.kernels.values()) > 0
    for key in ("flow_2d", "flow_3d"):
        assert torch.equal(out_plain[key], out_kernel[key])


# -- both workloads at the tiny size -------------------------------------------


@pytest.fixture(scope="module")
def tiny_runs():
    return {name: bench.measure(tiny(name, iters=1, warmup=0), CPU, 0, tiny_cfg())
            for name in bench.WORKLOADS}


@pytest.mark.parametrize("name", list(bench.WORKLOADS))
def test_workload_measured_at_tiny_size(tiny_runs, name):
    times, flop, peak, batches_gib, launches, faults = tiny_runs[name]
    assert len(times) == 1 and times[0] > 0
    assert flop > 0 and faults == []
    assert peak is None and batches_gib is None  # off the card
    assert launches == dict.fromkeys(bench.WORKLOADS[name].expected, 0)  # plain versions


def test_train_count_exceeds_eval(tiny_runs):
    """A step adds the backward's products (about twice the forward's) and
    the MI heads to the forward's."""
    assert tiny_runs["ft3d_train"][1] > 2 * tiny_runs["ft3d_eval"][1]


def test_traced_run_at_tiny_size():
    res = bench.layers(tiny("ft3d_eval"), CPU, 0, tiny_cfg(), runs=1)
    assert res["runs"] == 1 and res["busy_share"] == "not measured"
    assert res["host_ms"]["cuDNN conv"] > 0 and res["host_ms_total"] > 0
    assert res["launches_per_iter"] == dict.fromkeys(bench.EVAL_LAUNCHES, 0.0)


# -- the metric line and the refusals ------------------------------------------

DEVICE = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
TIMES = [410.0, 400.0, 430.0, 420.0, 500.0]  # median 420 ms, 2160 ms in all


def fake_line(name, flop=1e12, times=TIMES):
    wl = bench.WORKLOADS[name]
    return bench.metric_line(wl, times, flop, 30.5, 5.5, dict(wl.expected), DEVICE)


@pytest.mark.parametrize("name", list(bench.WORKLOADS))
def test_metric_line(name):
    line = fake_line(name)
    keys = {"workload", "metric", "value", "unit", "ms_window", "ms_median", "ms_q1", "ms_q3",
            "ms_min", "ms_max", "iters", "warmup", "ms_iters", "peak_gib", "batches_gib",
            "flop_per_iter", "mfu", "precision", "launches", "device"}
    if name == "ft3d_eval":
        keys.add("vs_baseline")
        assert (line["metric"], line["unit"]) == ("inference_throughput_ft3d_eval",
                                                  "frame_pairs_per_sec_per_chip")
        assert line["vs_baseline"] == pytest.approx(line["value"] / 8.0)
    else:
        assert (line["metric"], line["unit"]) == ("train_throughput_ft3d", "samples/s")
    assert set(line) == keys
    assert (line["ms_median"], line["ms_q1"], line["ms_q3"]) == (420.0, 410.0, 430.0)
    assert (line["ms_min"], line["ms_max"], line["iters"]) == (400.0, 500.0, 5)
    assert line["ms_window"] == 2160.0
    assert line["value"] == pytest.approx(4 * 5 / 2.160)  # the window's rate, not 4 / median
    assert line["mfu"] == pytest.approx(1e12 / (0.420 * 67e12))
    assert line["device"] == DEVICE and json.loads(json.dumps(line)) == line


def test_bench_accepts_a_sound_reading(capsys):
    lines = [fake_line(name) for name in bench.WORKLOADS]
    assert bench.report([(line, []) for line in lines]) == 0
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines


def _nan_output():
    return [{"flow_2d": torch.full((1, 4, 4, 2), math.nan), "flow_3d": torch.zeros(1, 8, 3)}]


@pytest.mark.parametrize("case", ["mfu over 1.05", "non-finite flow", "non-finite summary",
                                  "no parameter moved", "a launch short"])
def test_bench_refuses(case, capsys):
    name = "ft3d_eval" if case in ("mfu over 1.05", "non-finite flow") else "ft3d_train"
    wl = bench.WORKLOADS[name]
    line = fake_line(name, flop=1.06 * 0.420 * 67e12 if case == "mfu over 1.05" else 1e12)
    launches = dict(wl.expected)
    faults = []
    if case == "non-finite flow":
        faults = bench.output_faults(wl, _nan_output(), moved=False)
    elif case == "non-finite summary":
        faults = bench.output_faults(wl, [{"loss": 1.0}, {"loss": math.inf}], moved=True)
    elif case == "no parameter moved":
        faults = bench.output_faults(wl, [{"loss": 1.0}], moved=False)
    elif case == "a launch short":
        launches["dwconv"] -= 1
    reasons = bench.refusals(line, launches, wl.expected, faults)
    assert len(reasons) == 1, reasons
    assert bench.report([(fake_line("ft3d_eval"), []), (line, reasons)]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "refused" in err


def test_chip_smoke_reads_a_bench_run():
    lines = [fake_line(name) for name in bench.WORKLOADS]
    stdout = "\n".join(json.dumps(o) for o in [{"layers": {}, "device": DEVICE}] + lines)
    layers, read = bench.parse_output(stdout + "\n")
    assert layers == {} and read == {line["workload"]: line for line in lines}
    with pytest.raises(ValueError):
        bench.parse_output("\n".join(json.dumps(o) for o in [{"layers": {}}] + lines[:1]))
    with pytest.raises(ValueError):
        bench.parse_output("\n".join(json.dumps(o) for o in
                                      [{"layers": {}}, lines[0], dict(lines[1], mfu=1.2)]))
    with pytest.raises(ValueError):
        bench.parse_output("\n".join(json.dumps(o) for o in
                                      [{"layers": {}}, lines[0], dict(lines[1], value=math.nan)]))


def test_spread_tool_summarises_runs():
    """scripts/torch_bench_spread.py: per run the spread of the iterations,
    the first 3 timed iterations against the rest, the card's clock and
    power range; between runs the medians' and the values' range. A run
    with a metric line missing is refused (``bench.parse_output``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_bench_spread", os.path.join(REPO, "scripts", "torch_bench_spread.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    layers = {name: {"busy_share": [0.5, 0.6, 0.7]} for name in bench.WORKLOADS}
    runs = []
    for times in (TIMES, [t * 1.5 for t in TIMES]):
        lines = [fake_line(name, times=times) for name in bench.WORKLOADS]
        stdout = "\n".join(json.dumps(o) for o in [{"layers": layers, "device": DEVICE}] + lines)
        runs.append(tool.summarise(stdout, [(0.0, 1980.0, 120.5), (5.0, 1755.0, 250.0)]))
    eval_run = runs[0]["ft3d_eval"]
    assert (eval_run["ms_median"], eval_run["first3_median"], eval_run["rest_median"]) == (
        420.0, 410.0, 460.0)
    assert eval_run["q3_over_median"] == pytest.approx(430 / 420)
    assert eval_run["busy_share"] == [0.5, 0.6, 0.7]
    assert runs[0]["card"] == {"sm_mhz": [1755.0, 1980.0], "power_w": [120.5, 250.0],
                               "samples": 2}
    spread = tool.between(runs)
    assert set(spread) == set(bench.WORKLOADS)
    assert spread["ft3d_train"]["ms_median"]["range"] == [420.0, 630.0]
    assert spread["ft3d_train"]["ms_median"]["ratio"] == pytest.approx(1.5)
    assert spread["ft3d_eval"]["value"]["ratio"] == pytest.approx(1.5)
    with pytest.raises(ValueError):
        tool.summarise("\n".join(stdout.splitlines()[:-1]), [])


# -- no card -------------------------------------------------------------------


def test_bench_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run")
    proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "torch.cuda.is_available() is False" in proc.stderr and proc.stdout == ""
