#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rpeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: the Hopper kernels from rpeflow_tpu_torch/csrc (nvcc, one process
     per source);
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at every shape the flagship forward and training step give it,
     with timings (the depthwise conv: forward, rotated-taps input gradient
     and taps gradient);
  4. card vs CPU: the whole eval forward at a reduced shape, same weights;
  5. flagship: the FlyingThings3D eval forward (batch 4, 576x960, 20-channel
     event voxel, 8192 + 8192 points, 5 decode levels), launch counts of
     every kernel, metric sums, ms per batch;
  6. autograd on the card: the gradients of the correlation, MDTA, GDFN and
     depthwise-conv functions (kernels inside) against torch.autograd
     through their plain compositions, at level-1 shapes;
  7. train step, card vs CPU, at the reduced shape of phase 4, MI off, the
     CPU replaying the card's index and activation-sign choices: loss,
     per-leaf gradients and updated batch statistics;
  8. flagship training: conf/train/pretrain.yaml's model at the FT3D
     training shape (batch 4, 540x960 frames, 8192 + 8192 points), MI on,
     one warm-up and five timed steps, launches of every kernel in one step,
     then a checkpoint loaded strictly into the eval model.
The second-to-last line is a JSON object of per-kernel results, the last
``{"ok": true, "device": {...}}``. Weights and inputs are random, from seeds.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace as NS

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(b=4, h=576, w=960, n=8192, event_ch=20)
N_SAMPLES = (4096, 2048, 1024, 512, 256)
REDUCED = dict(b=1, h=128, w=192, n=2048, event_ch=20)
REDUCED_SAMPLES = (1024, 512, 256, 128, 64)
# FT3D training frames (540x960, resized to 576x960 inside); batch 4 is the
# per-GPU batch of the upstream recipe (16 over 4 GPUs)
TRAIN = dict(b=4, h=540, w=960, n=8192, event_ch=20)
# per decode level l = 1..5 at the flagship shape (576x960 -> 144x240 at l = 1)
LEVELS = [(144 >> i, 240 >> i, [32, 64, 96, 128, 192][i], 4096 >> i) for i in range(5)]
SOURCES = {
    "fps": ("rpeflow_tpu_torch/csrc/fps.cu", "rpeflow_tpu/ops/pallas/fps.py:53"),
    "correlation2d": ("rpeflow_tpu_torch/csrc/correlation.cu",
                      "rpeflow_tpu/ops/pallas/correlation.py:78"),
    "mdta_qkv": ("rpeflow_tpu_torch/csrc/mdta.cu", "rpeflow_tpu/ops/pallas/mdta.py:170"),
    "gdfn": ("rpeflow_tpu_torch/csrc/gdfn.cu", "rpeflow_tpu/ops/pallas/gdfn.py:135"),
    "dwconv": ("rpeflow_tpu_torch/csrc/dwconv.cu", "rpeflow_tpu/ops/pallas/dwconv.py:90"),
}
# kernels each path must launch (the eval forward's point-map GDFN runs the
# depthwise kernel too)
EXPECTED = {"eval forward": set(SOURCES), "train step": set(SOURCES)}


def model_cfg():
    """Model block of conf/test/things.yaml (the training losses of
    conf/train/pretrain.yaml added; the eval forward ignores them)."""
    losses = NS(level_weights=[8, 4, 2, 1, 0.5], order="l2")
    return NS(
        name="RPEFlow",
        freeze_bn=False,
        ids=NS(enabled=True, sensor_size_divisor=32),
        pwc2d=NS(event_bins=10, event_polarity=True, max_displacement=4,
                 norm=NS(feature_pyramid="batch_norm", flow_estimator=None,
                         context_network=None)),
        pwc3d=NS(k=16, norm=NS(feature_pyramid="batch_norm", correlation=None,
                               flow_estimator=None)),
        loss2d=losses,
        loss3d=losses,
    )


def training_cfg():
    """Training block of conf/train/pretrain.yaml."""
    return NS(max_epochs=600, optimizer="adam", weight_decay=1e-6, bias_decay=0.0,
              lr=NS(scheduler="MultiStepLR", init_value=4e-4, momentum=0.9, decay_rate=0.5,
                    decay_milestones=[400, 500]))


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
        batch["occ_mask_3d"] = (torch.rand(b, n, generator=g) > 0.8).float()
        # 4th channel: the loss's validity mask (non-occluded points)
        batch["flow_3d"] = torch.cat([flow3d, 1.0 - batch["occ_mask_3d"][..., None]], -1)
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


def max_rel(out, ref):
    """Largest difference relative to the largest entry of ``ref``."""
    return errors(out, ref)[1]


def phase_kernels(dev):
    """Each kernel vs its plain version at the flagship forward's and the
    training step's shapes."""
    from rpeflow_tpu_torch.ops import correlation, dwconv, fps, gdfn, mdta

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

    # K5 on the training step's shapes (one frame, batch 4): the q/k/v convs
    # of the 2-D MDTA blocks (C = c_l, 81, 96), the GDFN hidden maps
    # (2h = 2 int(2.66 C)), and the point maps' convs (kh = 1). Timed: the
    # kernel's forward + rotated-taps input gradient + taps gradient against
    # the plain conv's forward + autograd backward.
    dw_shapes = []
    for h, w, c, n in LEVELS:
        for cc in dict.fromkeys((c, 81, 96)):
            dw_shapes += [(4, h, w, cc, 3), (4, h, w, 2 * int(2.66 * cc), 3)]
        dw_shapes += [(4, 1, n, c, 1), (4, 1, n, 2 * int(2.66 * c), 1)]
    for b, h, w, c, kh in dw_shapes:
        x, gout = rnd(b, h, w, c), rnd(b, h, w, c)
        taps = rnd(kh, 3, c) / 3

        def kernel_pass():
            out = dwconv.dwconv_fwd(x, taps)
            dx = dwconv.dwconv_fwd(gout, taps.flip(0, 1).contiguous())
            return out, dx, dwconv.dwconv_taps_grad(x, gout, kh)

        xl, tl = x.clone().requires_grad_(), taps.clone().requires_grad_()

        def plain_pass():
            out = dwconv.dwconv_plain(xl, tl)
            return (out.detach(), *torch.autograd.grad(out, (xl, tl), gout))

        got, want = kernel_pass(), plain_pass()
        check_close("dwconv forward", got[0], want[0], atol=1e-5, rtol=0.0)
        check_close("dwconv input gradient", got[1], want[1], atol=1e-5, rtol=0.0)
        if max_rel(got[2], want[2]) > 1e-4:  # a sum over every pixel, in another order
            raise AssertionError(f"dwconv taps gradient: rel err {max_rel(got[2], want[2]):.3e}")
        record("dwconv", f"[{b},{h},{w},{c}] kh={kh} fwd+bwd", time_ms(kernel_pass),
               time_ms(plain_pass), max(errors(g_, w_)[0] for g_, w_ in zip(got[:2], want[:2])),
               max_rel(got[2], want[2]))
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


def check_launches(path, launches):
    missing = sorted(k for k in EXPECTED[path] if launches[k] == 0)
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")


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
    check_launches("eval forward", launches)
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


def phase_autograd(dev):
    """The autograd functions (kernels inside) against torch.autograd through
    their plain compositions, at one level-1 shape each: every gradient
    within 1e-4 of its largest entry."""
    from rpeflow_tpu_torch.ops import correlation, dwconv, gdfn, mdta

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    h, w, c, n = LEVELS[0]
    hid = int(2.66 * c)
    ln = torch.stack([1 + 0.1 * rnd(c), 0.1 * rnd(c), 1 + 0.1 * rnd(c), 0.1 * rnd(c)])
    cases = {
        "correlation2d": ((lambda a, b: correlation.correlation2d(a, b, 4)),
                          (lambda a, b: correlation.correlation2d_plain(a, b, 4)),
                          [rnd(4, h, w, c), rnd(4, h, w, c)]),
        "mdta": ((lambda *a: mdta.mdta_attention(*a, 3, 1)),
                 (lambda *a: mdta.mdta_attention_plain(*a, 3, 1)),
                 [rnd(4, h, w, c), rnd(4, h, w, c), ln, 0.3 * rnd(3, 3, 3 * c),
                  1 + 0.1 * rnd(1, 1, 1), rnd(c, c) / c ** 0.5]),
        "mdta points": ((lambda *a: mdta.mdta_attention(*a, 1, 1)),
                        (lambda *a: mdta.mdta_attention_plain(*a, 1, 1)),
                        [rnd(4, 1, n, c), rnd(4, 1, n, c), ln, 0.3 * rnd(1, 3, 3 * c),
                         1 + 0.1 * rnd(1, 1, 1), rnd(c, c) / c ** 0.5]),
        "gdfn": (gdfn.gdfn, gdfn.gdfn_plain,
                 [rnd(4, h, w, c), rnd(c, 2 * hid) / c ** 0.5, rnd(3, 3, 2 * hid) / 3,
                  rnd(hid, c) / hid ** 0.5]),
        "dwconv": (dwconv.dwconv, dwconv.dwconv_plain, [rnd(4, h, w, 2 * hid), rnd(3, 3, 2 * hid) / 3]),
    }
    for name, (fn, plain, inputs) in cases.items():
        grads = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            out = f(*leaves)
            if not grads:
                gout = torch.randn(out.shape, generator=g, device=dev)
            out.backward(gout)
            grads.append([t.grad for t in leaves])
        worst = max(max_rel(a, b) for a, b in zip(*grads))
        print(f"  {name:14s} {tuple(inputs[0].shape)}: largest gradient error "
              f"{worst:.3e} of the largest entry", flush=True)
        if worst > 1e-4:
            raise AssertionError(f"autograd {name}: gradient error {worst:.3e} > 1e-4")


def _grad_bound_ok(d, scale):
    """Per-leaf bound of tests/test_segmented_train.py."""
    return d <= 2e-3 * max(scale, 1.0) + 1e-4


def pre_norm_biases(model):
    """Names of the biases that feed a batch norm in training mode. The norm
    subtracts the batch mean, so their exact gradient is 0, and what either
    device computes for them is rounding noise of the gradients behind."""
    from rpeflow_tpu_torch.nn.layers import ConvNormAct
    from rpeflow_tpu_torch.nn.pointconv import PointConv

    names = set()
    for name, mod in model.named_modules():
        if getattr(mod, "norm", None) != "batch_norm":
            continue
        if isinstance(mod, ConvNormAct):
            names.add(f"{name}.conv_fn.bias")
        elif isinstance(mod, PointConv):
            names.add(f"{name}.linear.bias")
    return names


@contextlib.contextmanager
def shared_choices(tape, replay):
    """Within the block, the model's discrete choices -- the indices of every
    FPS and nearest-neighbour search, the sign test of every (leaky) ReLU --
    are recorded on ``tape`` (``replay`` False) or, each computed all the
    same, replaced by the recorded ones in call order (``replay`` True).
    The searches rank squared distances in the matmul form, which rounds at
    the scale of |q|^2, and an activation's input near 0 changes sign with
    the last bits of the conv before it, so near-ties fall differently on
    the card and on the CPU. One flipped leaky ReLU moves a conv's weight
    gradient by several times the per-leaf bound, so the devices are held
    to one computation: the same choices, each device's own arithmetic.
    Yields ``{"indices" | "signs": [differing, total]}``."""
    import importlib

    import torch.nn.functional as F

    counts = {"indices": [0, 0], "signs": [0, 0]}
    pos = iter(range(len(tape)))

    def share(kind, own):
        if not replay:
            tape.append(own)
            return own
        rec = tape[next(pos)].to(own.device)
        if rec.shape != own.shape:
            raise AssertionError(f"replayed {kind} {tuple(rec.shape)} vs {tuple(own.shape)}")
        counts[kind][0] += int((rec != own).sum())
        counts[kind][1] += own.numel()
        return rec

    def search(fn):
        return lambda *args: share("indices", fn(*args))

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(share("signs", x.detach() > 0), x, negative_slope * x)

    def relu(x, inplace=False):
        return torch.where(share("signs", x.detach() > 0), x, torch.zeros_like(x))

    patches = [(F, "leaky_relu", leaky_relu), (F, "relu", relu)]
    for mod_name, names in {
            "rpeflow_tpu_torch.nn.pyramid3d": ("furthest_point_sampling", "k_nearest_neighbor"),
            "rpeflow_tpu_torch.nn.pointconv": ("k_nearest_neighbor",),
            "rpeflow_tpu_torch.ops.interp": ("k_nearest_neighbor",),
            "rpeflow_tpu_torch.model.core": ("k_nearest_neighbor",)}.items():
        mod = importlib.import_module(mod_name)
        patches += [(mod, name, search(getattr(mod, name))) for name in names]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# Largest share of the CPU's own discrete choices that may differ from the
# card's in phase 7 before the replay would hide a fault: about 4x and 40x
# the readings of 188 of 150,780 indices and 5 of 20.2M signs on an H100.
REPLAY_BOUND = {"indices": 5e-3, "signs": 1e-5}


def phase_train_card_vs_cpu(dev):
    """One train step (MI off) of the same model on the card and on the CPU,
    the CPU replaying the card's discrete choices (:func:`shared_choices`),
    whose own choices may differ in at most ``REPLAY_BOUND`` of them: loss rtol 1e-4, per-leaf gradients
    |d| <= 2e-3 max(|g|max, 1) + 1e-4, updated batch statistics rtol 1e-4,
    atol 1e-6. A bias that feeds a batch norm (exact gradient 0) is held
    instead to |g| <= 1e-6 of the largest gradient entry of the model, on
    both devices."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    cpu_model = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), SEED).train()
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = make_batch(SEED + 4, device="cpu", targets=True, **REDUCED)
    runs, tape = {}, []
    for name, model, device in (("card", card_model, dev), ("cpu", cpu_model, "cpu")):
        opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
        with shared_choices(tape, replay=name == "cpu") as counts:
            runs[name] = train_step(model, opt, {k: t.to(device) for k, t in batch.items()},
                                    None, compute_mi=False)
    ref, out = runs["cpu"], runs["card"]
    print("  the CPU's own choices differ from the card's (replayed): " + ", ".join(
        f"{k} {d} of {n} (bound {REPLAY_BOUND[k]:.0e} of them)"
        for k, (d, n) in counts.items()), flush=True)
    bad = [(f"replayed {k}", d, n) for k, (d, n) in counts.items()
           if not 0 < n or d > REPLAY_BOUND[k] * n]
    print("  " + "; ".join(f"{k} card {out[k]:.6f} cpu {ref[k]:.6f}"
                           for k in ("loss", "loss_2d", "loss_3d", "grad_norm")), flush=True)
    if not np.isfinite(out["loss"]) or abs(out["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        bad.append(("loss", out["loss"], ref["loss"]))
    worst = 0.0
    cpu_params = dict(cpu_model.named_parameters())
    zero_grad = pre_norm_biases(cpu_model)
    g_max = max(float(p.grad.abs().max()) for p in cpu_params.values() if p.grad is not None)
    for name, p in card_model.named_parameters():
        g_ref = cpu_params[name].grad
        if g_ref is None:
            continue
        g = p.grad.cpu()
        if name in zero_grad:
            noise = max(float(g.abs().max()), float(g_ref.abs().max()))
            if noise > 1e-6 * g_max:
                bad.append((name, noise, g_max))
            continue
        d = float((g - g_ref).abs().max())
        scale = float(g_ref.abs().max())
        worst = max(worst, d / (2e-3 * max(scale, 1.0) + 1e-4))
        if not _grad_bound_ok(d, scale):
            bad.append((name, d, scale))
    print(f"  per-leaf gradients: worst |d| at {worst:.3f} of the bound; {len(zero_grad)} "
          f"pre-norm biases held to 1e-6 of the largest entry ({g_max:.3e})", flush=True)
    cpu_buffers = dict(cpu_model.named_buffers())
    n_stats = 0
    for name, buf in card_model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            if not torch.allclose(buf.cpu(), cpu_buffers[name], rtol=1e-4, atol=1e-6):
                bad.append((name, errors(buf.cpu(), cpu_buffers[name])[0], None))
    print(f"  {n_stats} updated batch statistics against rtol 1e-4, atol 1e-6; outside a bound: "
          f"{len(bad)}", flush=True)
    if bad:
        raise AssertionError(f"train step card vs CPU outside the bounds: {bad[:8]}")


def phase_train_flagship(dev):
    """conf/train/pretrain.yaml's model at the FT3D training shape, MI on."""
    from rpeflow_tpu_torch.compat import load_checkpoint
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train.checkpoint import save_checkpoint
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, make_batch(SEED + 20, device=dev, targets=True, **TRAIN), gen)
    batches = [make_batch(SEED + 21 + i, device=dev, targets=True, **TRAIN) for i in range(5)]
    losses, launches = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, bt in enumerate(batches):
        if i == 0:
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
        summary = train_step(model, opt, bt, gen)
        if i == 0:
            torch.cuda.synchronize()
            launches = dict(_cuda.LAUNCHES)
        losses.append(summary)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(batches)
    print(f"  launches in one train step: {launches}")
    check_launches("train step", launches)
    for i, sm in enumerate(losses):
        print(f"  step {i + 1}: loss {sm['loss']:.4f} (2d {sm['loss_2d']:.4f}, 3d "
              f"{sm['loss_3d']:.4f}, mi {sm['mi_loss']:.6f}), grad_norm {sm['grad_norm']:.3f}")
        if not all(np.isfinite(v) for v in sm.values()):
            raise AssertionError(f"flagship train step {i + 1}: non-finite summary {sm}")
        if sm["mi_loss"] == 0.0:
            raise AssertionError("flagship train step: MI loss is 0")
    b = TRAIN["b"]
    print(f"  flagship train step: {dt * 1e3:.2f} ms/step at batch {b} ({b / dt:.2f} "
          f"frame-pairs/s; 5 steps, inputs differ per step, MI on); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    after = {k: v.detach() for k, v in model.named_parameters()}
    moved = sum(float((after[k] - v).abs().max()) > 0 for k, v in before.items())
    temps = [k for k in before if k.endswith("temperature")]
    if any(not torch.equal(after[k], before[k]) for k in temps):
        raise AssertionError("the frozen MDTA temperature moved")
    print(f"  {moved} of {len(before)} parameters moved; {len(temps)} temperatures frozen")
    if moved < len(before) // 2:
        raise AssertionError("too few parameters moved")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(model, opt, batches[0], gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avgs.table(sort_by=key, row_limit=25))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, model, opt, 1, None)
        eval_model = RPEFlow(model_cfg(), N_SAMPLES)
        load_checkpoint(eval_model, path, strict=True)
    print("  checkpoint saved and loaded strictly into the eval model", flush=True)
    return launches, {"ms_per_step": dt * 1e3, "batch": b,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


T0 = time.perf_counter()


def phase(title):
    print(f"{title} (at {time.perf_counter() - T0:.0f} s)", flush=True)


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

    phase("[3] kernels vs plain PyTorch (TF32 off; median of 20 timed runs)")
    kernel_results = phase_kernels(dev)
    phase("[4] card vs CPU, whole slice at batch 1, 128x192, 2048 points")
    phase_card_vs_cpu(dev)
    phase("[5] flagship forward, batch 4, 576x960, 8192 + 8192 points")
    phase_flagship(dev)
    phase("[6] autograd functions on the card vs torch.autograd of the plain versions")
    phase_autograd(dev)
    phase("[7] train step, card vs CPU, batch 1, 128x192, 2048 points, MI off")
    phase_train_card_vs_cpu(dev)
    phase("[8] flagship training, pretrain.yaml model, 540x960, 8192 + 8192 points, MI on")
    launches, _ = phase_train_flagship(dev)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                "max_abs_err": kernel_results[name]["max_abs_err"],
                "ms": kernel_results[name]["ms"], "plain_ms": kernel_results[name]["plain_ms"]}
               for name, (src, rep) in SOURCES.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
