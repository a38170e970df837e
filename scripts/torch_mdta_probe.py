"""Where the MDTA kernel's time goes, and its time under other plans.

    python scripts/torch_mdta_probe.py

On the first CUDA device, timed as ``chip_smoke.py`` phase 3 times a call
(CUDA events around one wrapper call, median of 20):

1. tiles: the 2-D maps of the flagship forward's decode levels 1-3 (where
   ``rpeflow_tpu_torch/csrc/mdta.cu`` spends most of its time) under the
   plan of ``ops/mdta.py : mdta_plan``, under every other 8-row tile of
   4-16 columns (and row segment) in ``TILES`` that fits one block, and
   under the plan's tile with half the blocks; each checked against the
   plan's result;
2. flagship: the 30 shapes of one flagship forward under the plan, their
   sum, and the device time of the two kernels of each call
   (torch.profiler), under the plan and with a quarter of its blocks;
3. floor: the smallest call (one token), and the host time of the
   wrapper's parts;
4. phases: the kernel with each phase compiled out in turn (built into
   ``build/mdta_phases/`` by guarding literal fragments of ``csrc/mdta.cu``
   with ``#ifndef``; stops where a fragment is gone): the LayerNorms, the
   taps, the sq sums, the Gram products, the next tile's halo loads, and all
   of them. Those outputs are wrong by design.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import LEVELS, time_ms  # noqa: E402
from rpeflow_tpu_torch.ops import _cuda, mdta  # noqa: E402

SHAPES = ((8, 144, 240, 32), (4, 144, 240, 81), (4, 144, 240, 96), (8, 72, 120, 64),
          (4, 72, 120, 96), (8, 36, 60, 96), (4, 36, 60, 96))
TILES = ((8, 4, 4), (8, 8, 8), (8, 12, 6), (8, 12, 12), (8, 16, 8), (8, 16, 16))


def inputs(g, b, h, w, c, kh):
    dev = g.device
    x = torch.randn(b, h, w, c, generator=g, device=dev)
    y = torch.randn(b, h, w, c, generator=g, device=dev)
    ln = 1 + 0.1 * torch.randn(4, c, generator=g, device=dev)
    return x, y, ln, 0.2 * torch.randn(kh, 3, 3 * c, generator=g, device=dev)


def host_us(fn, n=200) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls, one sync at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def device_us(fn) -> float:
    """Device microseconds of the two kernels of one call (torch.profiler)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
               for e in prof.key_averages() if "mdta_kernel" in e.key or "sum_partials" in e.key)


def tiles(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    sms = _cuda.sm_count(dev)
    for b, h, w, c in SHAPES:
        x, y, ln, dw = inputs(g, b, h, w, c, 3)
        default = mdta.mdta_plan(b, h, w, c, 3, sms)
        plans = {f"plan {default.th}x{default.tw}/{default.seg} nblk {default.nblk}": default}
        for tile in TILES:
            plan = mdta.mdta_plan(b, h, w, c, 3, sms, tile=tile)
            if tile != (default.th, default.tw, default.seg) and \
                    plan.smem_bytes <= mdta.SMEM_PER_BLOCK:
                plans[f"{tile[0]}x{tile[1]}/{tile[2]} nblk {plan.nblk}"] = plan
        nblk = max(1, default.nblk // 2)
        plans[f"plan tile, nblk {nblk}"] = replace(default, nblk=nblk)
        ref = mdta.launch_qkv(x, y, ln, dw, default)
        row = []
        for name, plan in plans.items():
            out = mdta.launch_qkv(x, y, ln, dw, plan)
            torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
            for o, r in zip(out[1:], ref[1:]):
                assert float((o - r).abs().max() / r.abs().max()) <= 1e-4, name
            row.append(f"{name}: {time_ms(lambda: mdta.launch_qkv(x, y, ln, dw, plan)):.4f}")
        print(f"mdta tiles {(b, h, w, c)}: " + "  ".join(row), flush=True)


def flagship(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    total, row, dev_row = 0.0, [], []
    for h, w, c, n in LEVELS:
        for shape in ((8, h, w, c, 3), (4, h, w, 81, 3), (4, h, w, 96, 3),
                      (8, 1, n, c, 1), (4, 1, n, c, 1), (4, 1, n, 64, 1)):
            args = (*inputs(g, *shape), shape[-1])
            ms = time_ms(lambda: mdta.mdta_qkv(*args))
            total += ms
            row.append(f"{shape} {ms:.4f}")
            plan = mdta.mdta_plan(*shape, _cuda.sm_count(dev))
            fewer = replace(plan, nblk=max(1, plan.nblk // 4))
            dev_row.append(f"{shape} {device_us(lambda: mdta.mdta_qkv(*args)):.1f} (nblk "
                           f"{plan.nblk}; {fewer.nblk}: "
                           f"{device_us(lambda: mdta.launch_qkv(*args[:4], fewer)):.1f})")
    print("mdta flagship shapes, ms: " + "; ".join(row), flush=True)
    print("mdta flagship shapes, device us: " + "; ".join(dev_row), flush=True)
    print(f"mdta flagship sum over 30 shapes: {total:.4f} ms", flush=True)


def floor(dev) -> None:
    """The smallest call (one token, C = 32, kh = 1): its event time as
    chip_smoke.py takes it, and the host time of the wrapper's parts."""
    x, y = (torch.randn(1, 1, 1, 32, device=dev) for _ in range(2))
    ln, dw = torch.ones(4, 32, device=dev), torch.ones(1, 3, 96, device=dev)
    plan = mdta.mdta_plan(1, 1, 1, 32, 1, _cuda.sm_count(dev))
    v, qk, sq = mdta.launch_qkv(x, y, ln, dw, plan)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    refused = replace(plan, nblk=0)
    lib = _cuda.lib()
    raw = (x.data_ptr(), y.data_ptr(), ln.data_ptr(), dw.data_ptr(), v.data_ptr(),
           qk.data_ptr(), sq.data_ptr(), scratch.data_ptr())
    parts = {
        "mdta_qkv": lambda: mdta.mdta_qkv(x, y, ln, dw, 1),
        "launch_qkv": lambda: mdta.launch_qkv(x, y, ln, dw, plan),
        "C call (two launches)": lambda: lib.rpeflow_mdta_qkv(*raw, plan.c_plan[1],
                                                              _cuda.stream(dev)),
        "C call refused (no launch)": lambda: lib.rpeflow_mdta_qkv(*raw, refused.c_plan[1],
                                                                   _cuda.stream(dev)),
        "stream()": lambda: _cuda.stream(dev),
        "torch.empty": lambda: torch.empty(plan.scratch_floats, device=dev),
        "require_cuda": lambda: _cuda.require_cuda("mdta_qkv", x, y, ln, dw),
        "plan lookup": lambda: mdta._cached_plan(1, 1, 1, 32, 1, 0),
    }
    print(f"mdta floor (1, 1, 1, 32), kh 1: event {time_ms(parts['mdta_qkv']):.4f} ms; host us "
          "per call: " + "  ".join(f"{k} {host_us(fn):.2f}" for k, fn in parts.items()),
          flush=True)


def _guard(src: str, start: str, end: str, macro: str) -> str:
    """Wrap the code from ``start`` to the regex ``end`` in ``#ifndef macro``."""
    i = src.index(start)
    j = re.compile(end).search(src, i).end()
    return f"{src[:i]}\n#ifndef {macro}\n{src[i:j]}\n#endif\n{src[j:]}"


def phase_source() -> str:
    src = (_cuda.CSRC / "mdta.cu").read_text()
    for name, macro in (("hx", "NO_LN"), ("hy", "NO_LN")):
        src = _guard(src, f"layer_norm<CP, KH, NT>({name},", r";", macro)
    src = _guard(src, "taps_q<CP, KH, NT>(hx,", r";", "NO_TAPS")
    src = _guard(src, "taps_kv<CP, NS, KH, NT>(hy,", r";", "NO_TAPS")
    for name in ("hx", "hy"):
        src = _guard(src, f"if (next < g.tiles) load_halo<CP, KH, NT>({name},", r";", "NO_LOAD")
    src = _guard(src, "if (sq_ph < P) {", r"sqa = a;\s*\}", "NO_SQ")
    src = _guard(src, "for (int k0 = 8 * kg; k0 < tt; k0 += 8 * KG) {",
                 r"mma3\(acc, ab, as, bb, bs\);\s*\}", "NO_GRAM")
    return src


PHASES = {"full": [], "no_ln": ["-DNO_LN"], "no_taps": ["-DNO_TAPS"], "no_sq": ["-DNO_SQ"],
          "no_gram": ["-DNO_GRAM"], "no_load": ["-DNO_LOAD"],
          "none": ["-DNO_LN", "-DNO_TAPS", "-DNO_SQ", "-DNO_GRAM", "-DNO_LOAD"]}


def phases(dev) -> None:
    out_dir = _cuda.BUILD_ROOT.parent / "mdta_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mdta_variants.cu"
    src.write_text(phase_source())
    nvcc = _cuda._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC), *flags,
         "-o", str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in PHASES.items()}
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).rpeflow_mdta_qkv
        fn.argtypes, fn.restype = _cuda._SIGNATURES["rpeflow_mdta_qkv"]
        fns[name] = fn
    g = torch.Generator(device=dev).manual_seed(2)
    for b, h, w, c in SHAPES[:4]:
        x, y, ln, dw = inputs(g, b, h, w, c, 3)
        plan = mdta.mdta_plan(b, h, w, c, 3, _cuda.sm_count(dev))
        v, qk, sq = mdta.launch_qkv(x, y, ln, dw, plan)
        scratch = torch.empty(plan.scratch_floats, device=dev)
        args = (x.data_ptr(), y.data_ptr(), ln.data_ptr(), dw.data_ptr(), v.data_ptr(),
                qk.data_ptr(), sq.data_ptr(), scratch.data_ptr(), plan.c_plan[1], _cuda.stream(dev))
        row = {name: time_ms(lambda: fn(*args)) for name, fn in fns.items()}
        print(f"mdta phases {(b, h, w, c)}: " + "  ".join(f"{k} {t:.4f}" for k, t in row.items()),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mdta_probe needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    tiles(dev)
    flagship(dev)
    floor(dev)
    phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
