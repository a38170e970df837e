#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rpeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: the Hopper kernels from rpeflow_tpu_torch/csrc (nvcc);
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at every shape the flagship forward gives it, with timings;
  4. card vs CPU: the whole eval forward at a reduced shape, same weights;
  5. flagship: the FlyingThings3D eval forward (batch 4, 576x960, 20-channel
     event voxel, 8192 + 8192 points, 5 decode levels), launch counts of
     every kernel, metric sums, ms per batch.
The second-to-last line is a JSON object of per-kernel results, the last
``{"ok": true, "device": {...}}``. Weights and inputs are random, from seeds.
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace as NS

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(b=4, h=576, w=960, n=8192, event_ch=20)
N_SAMPLES = (4096, 2048, 1024, 512, 256)
REDUCED = dict(b=1, h=128, w=192, n=2048, event_ch=20)
REDUCED_SAMPLES = (1024, 512, 256, 128, 64)
# per decode level l = 1..5 at the flagship shape (576x960 -> 144x240 at l = 1)
LEVELS = [(144 >> i, 240 >> i, [32, 64, 96, 128, 192][i], 4096 >> i) for i in range(5)]


def model_cfg():
    """Model block of conf/test/things.yaml."""
    return NS(
        name="RPEFlow",
        ids=NS(enabled=True, sensor_size_divisor=32),
        pwc2d=NS(event_bins=10, event_polarity=True, max_displacement=4,
                 norm=NS(feature_pyramid="batch_norm", flow_estimator=None,
                         context_network=None)),
        pwc3d=NS(k=16, norm=NS(feature_pyramid="batch_norm", correlation=None,
                               flow_estimator=None)),
    )


def make_batch(seed, b, h, w, n, event_ch, device, targets=False):
    """Synthetic FT3D-like batch whose points project inside the image."""
    g = torch.Generator().manual_seed(seed)
    f, cx, cy = 1050.0, (w - 1) / 2, (h - 1) / 2
    z = 2.0 + 33.0 * torch.rand(b, n, generator=g)
    u = torch.rand(b, n, generator=g) * (w - 1)
    v = torch.rand(b, n, generator=g) * (h - 1)
    pc1 = torch.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1)
    flow3d = 0.1 * torch.randn(b, n, 3, generator=g)
    batch = {
        "images": torch.randint(0, 256, (b, h, w, 6), generator=g, dtype=torch.uint8),
        "pcs": torch.cat([pc1, pc1 + flow3d], -1),
        "event_voxel": torch.rand(b, h, w, event_ch, generator=g),
        "intrinsics": torch.tensor([[f, cx, cy]]).repeat(b, 1),
    }
    if targets:
        batch["flow_2d"] = torch.cat([4 * torch.randn(b, h, w, 2, generator=g),
                                      torch.ones(b, h, w, 1)], -1)
        batch["flow_3d"] = flow3d
        batch["occ_mask_3d"] = (torch.rand(b, n, generator=g) > 0.8).float()
    return {k: t.to(device) for k, t in batch.items()}


def time_ms(fn, runs=20, warmup=3):
    """Median ms of ``fn()`` over ``runs`` calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def errors(out, ref):
    d = (out.double() - ref.double()).abs()
    scale = ref.double().abs().max().clamp_min(1e-30)
    return float(d.max()), float(d.max() / scale)


def check_close(name, out, ref, atol, rtol):
    ok = torch.allclose(out, ref, atol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"{name}: max |d| {errors(out, ref)[0]:.3e} beyond "
                             f"atol {atol} rtol {rtol}")


def phase_kernels(dev):
    """Each kernel vs its plain version at the flagship forward's shapes."""
    from rpeflow_tpu_torch.ops import correlation, fps, gdfn, mdta

    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    results = {}

    def record(name, shape, out_ms, plain_ms, abs_err, rel_err):
        r = results.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0})
        r["ms"] += out_ms
        r["plain_ms"] += plain_ms
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        print(f"  {name:14s} {shape:34s} kernel {out_ms:9.4f} ms  plain {plain_ms:9.4f} ms"
              f"  max|d| {abs_err:.3e}  rel {rel_err:.3e}", flush=True)

    # K1: one FPS over both clouds stacked, [8, 8192, 3] -> 4096
    xyz = torch.rand(8, 8192, 3, generator=g, device=dev) * torch.tensor([20., 12., 33.], device=dev)
    out = fps.furthest_point_sampling(xyz, 4096)
    ref = fps.furthest_point_sampling_plain(xyz, 4096)
    torch.cuda.synchronize()
    n_diff = int((out != ref).sum())
    if n_diff:
        raise AssertionError(f"fps: {n_diff} indices differ from the plain version")
    record("fps", "[8,8192,3] -> 4096", time_ms(lambda: fps.furthest_point_sampling(xyz, 4096)),
           time_ms(lambda: fps.furthest_point_sampling_plain(xyz, 4096), runs=20, warmup=1),
           0.0, 0.0)

    for h, w, c, _ in LEVELS:
        f1, f2 = rnd(4, h, w, c), rnd(4, h, w, c)
        out = correlation.correlation2d(f1, f2, 4)
        ref = correlation.correlation2d_plain(f1, f2, 4)
        check_close("correlation2d", out, ref, atol=1e-5, rtol=0.0)
        record("correlation2d", f"[4,{h},{w},{c}]",
               time_ms(lambda: correlation.correlation2d(f1, f2, 4)),
               time_ms(lambda: correlation.correlation2d_plain(f1, f2, 4)), *errors(out, ref))

    mdta_shapes, gdfn_shapes = [], []
    for h, w, c, n in LEVELS:
        mdta_shapes += [(8, h, w, c, 3), (4, h, w, 81, 3), (4, h, w, 96, 3),
                        (8, 1, n, c, 1), (4, 1, n, c, 1), (4, 1, n, 64, 1)]
        gdfn_shapes += [(8, h, w, c), (4, h, w, 81), (4, h, w, 96)]
    for b, h, w, c, kh in mdta_shapes:
        x, y = rnd(b, h, w, c), rnd(b, h, w, c)
        ln = torch.stack([1 + 0.1 * rnd(c), 0.1 * rnd(c), 1 + 0.1 * rnd(c), 0.1 * rnd(c)])
        dw = 0.2 * rnd(kh, 3, 3 * c)
        v, qk, sq = mdta.mdta_qkv(x, y, ln, dw, kh)
        rv, rqk, rsq = mdta.mdta_qkv_plain(x, y, ln, dw, kh)
        check_close("mdta_qkv v", v, rv, atol=1e-5, rtol=0.0)
        # qk/sq: sums over up to 34,560 tokens in another order; relative to
        # the largest entry (entries near 0 are differences of large sums)
        for nm, o, r in (("qk", qk, rqk), ("sq", sq, rsq)):
            rel = errors(o, r)[1]
            if rel > 1e-4:
                raise AssertionError(f"mdta_qkv {nm}: rel err {rel:.3e} > 1e-4")
        errs = [errors(v, rv), errors(qk, rqk), errors(sq, rsq)]
        record("mdta_qkv", f"[{b},{h},{w},{c}] kh={kh}",
               time_ms(lambda: mdta.mdta_qkv(x, y, ln, dw, kh)),
               time_ms(lambda: mdta.mdta_qkv_plain(x, y, ln, dw, kh)),
               errs[0][0], max(e[1] for e in errs[1:]))
    for b, h, w, c in gdfn_shapes:
        hid = int(c * 2.66)
        x = rnd(b, h, w, c)
        w_in = rnd(c, 2 * hid) / c ** 0.5
        w_dw = rnd(3, 3, 2 * hid) / 3.0
        w_out = rnd(hid, c) / hid ** 0.5
        out = gdfn.gdfn(x, w_in, w_dw, w_out)
        ref = gdfn.gdfn_plain(x, w_in, w_dw, w_out)
        check_close("gdfn", out, ref, atol=1e-5, rtol=1e-4)
        record("gdfn", f"[{b},{h},{w},{c}] hidden {hid}",
               time_ms(lambda: gdfn.gdfn(x, w_in, w_dw, w_out)),
               time_ms(lambda: gdfn.gdfn_plain(x, w_in, w_dw, w_out)), *errors(out, ref))
    return results


def phase_card_vs_cpu(dev):
    """The whole slice on the card (kernels) and on the CPU (plain versions)."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_

    model = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), SEED)
    batch = make_batch(SEED + 1, device="cpu", **REDUCED)
    with torch.inference_mode():
        ref = model(batch)
        model.to(dev)
        out = model({k: t.to(dev) for k, t in batch.items()})
    atol = 2e-2
    for key in ("flow_2d", "flow_3d"):
        o, r = out[key].cpu().double(), ref[key].double()
        if not torch.isfinite(o).all():
            raise AssertionError(f"card vs CPU: non-finite {key}")
        d = (o - r).abs()
        frac = float((d <= atol + 1e-3 * r.abs()).double().mean())
        print(f"  {key}: {tuple(o.shape)}  within tol {frac:.4%}  mean|d| {float(d.mean()):.3e}"
              f"  max|d| {float(d.max()):.3e}", flush=True)
        if frac < 0.995 or float(d.mean()) >= atol:
            raise AssertionError(f"card vs CPU: {key} outside the tolerance model")


def phase_flagship(dev):
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train.evaluator import _metric_sums

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev)
    keys = ("images", "pcs", "event_voxel", "intrinsics")
    batch = make_batch(SEED + 2, device=dev, targets=True, **FLAGSHIP)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        out = model({k: batch[k] for k in keys})
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        sums = {k: float(v) for k, v in _metric_sums(out, batch, True).items()}
    print(f"  launches in one forward: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    b, h, w, n = FLAGSHIP["b"], FLAGSHIP["h"], FLAGSHIP["w"], FLAGSHIP["n"]
    if tuple(out["flow_2d"].shape) != (b, h, w, 2) or tuple(out["flow_3d"].shape) != (b, n, 3):
        raise AssertionError(f"output shapes {[tuple(t.shape) for t in out.values()]}")
    for key, t in out.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"flagship {key} not finite")
    if not all(np.isfinite(v) for v in sums.values()):
        raise AssertionError(f"metric sums not finite: {sums}")
    print(f"  outputs finite; metric sums {sums}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    iters = 10
    batches = [make_batch(SEED + 10 + i, device=dev, **{**FLAGSHIP}) for i in range(iters)]
    with torch.inference_mode():
        model(batches[-1])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bt in batches:
            last = model(bt)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
    if not torch.isfinite(last["flow_2d"]).all():
        raise AssertionError("timed forward not finite")
    print(f"  flagship forward: {dt * 1e3:.2f} ms/batch of {b}, {b / dt:.2f} frame-pairs/s"
          f" ({iters} forwards, inputs differ per iteration)", flush=True)

    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        model(batches[0])
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avgs.table(sort_by=key, row_limit=25))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rpeflow_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_info['seconds']:.1f} s)")
    for line in _cuda.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("   ", line.strip())

    print("[3] kernels vs plain PyTorch (TF32 off; median of 20 timed runs)", flush=True)
    kernel_results = phase_kernels(dev)
    print("[4] card vs CPU, whole slice at batch 1, 128x192, 2048 points", flush=True)
    phase_card_vs_cpu(dev)
    print("[5] flagship forward, batch 4, 576x960, 8192 + 8192 points", flush=True)
    launches = phase_flagship(dev)

    sources = {
        "fps": ("rpeflow_tpu_torch/csrc/fps.cu", "rpeflow_tpu/ops/pallas/fps.py:53"),
        "correlation2d": ("rpeflow_tpu_torch/csrc/correlation.cu",
                          "rpeflow_tpu/ops/pallas/correlation.py:78"),
        "mdta_qkv": ("rpeflow_tpu_torch/csrc/mdta.cu", "rpeflow_tpu/ops/pallas/mdta.py:170"),
        "gdfn": ("rpeflow_tpu_torch/csrc/gdfn.cu", "rpeflow_tpu/ops/pallas/gdfn.py:135"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                "max_abs_err": kernel_results[name]["max_abs_err"],
                "ms": kernel_results[name]["ms"], "plain_ms": kernel_results[name]["plain_ms"]}
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
