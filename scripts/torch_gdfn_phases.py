"""Where the GDFN kernel's time goes: each phase compiled out in turn.

    python scripts/torch_gdfn_phases.py

A probe of ``rpeflow_tpu_torch/csrc/gdfn.cu`` as it stands: it guards the
kernel's phases with ``#ifndef`` by finding literal fragments of its code,
and stops with an error where a fragment is gone. Builds variants into
``build/gdfn_phases/`` with nvcc (``-I`` to ``csrc/`` for the shared header):
``full``; ``no_a`` / ``no_b`` / ``no_c`` without the first product, the
gate or the second product; ``no_erf`` with the gate's GELU replaced by the
identity; ``no_w`` without the weight loads after the first chunk; ``none``
without the three phases (loads, barriers and the output store only). Each
variant's output is wrong by design: this measures time, not results. Prints
the median ms of each variant at the flagship shapes where the kernel spends
most of its time, on the first CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rpeflow_tpu_torch.ops import _cuda  # noqa: E402

SHAPES = ((4, 144, 240, 96), (4, 144, 240, 81), (8, 144, 240, 32), (8, 18, 30, 128),
          (8, 9, 15, 192))


def _guard(src: str, start: str, end: str, macro: str) -> str:
    """Wrap the code from ``start`` to the regex ``end`` in ``#ifndef macro``."""
    i = src.index(start)
    j = re.compile(end).search(src, i).end()
    return f"{src[:i]}\n#ifndef {macro}\n{src[i:j]}\n#endif\n{src[j:]}"


def variant_source() -> str:
    src = (_cuda.CSRC / "gdfn.cu").read_text()
    src = _guard(src, "for (int k0 = 0; k0 < ck; k0 += 8) {",
                 r"mma3\(acc, ab, as, bb, bs\);\s*\}", "NO_A")
    src = _guard(src, "for (int cc = 0;", r"\* keep;\s*\}\s*\}", "NO_B")
    src = _guard(src, "// (c) y_acc += g @ w_out chunk", r"mma3\(y, ab, as, bb, bs\);\s*\}",
                 "NO_C")
    src = src.replace("gelu_exact(a0) * a1 * keep", "GATE(a0) * a1 * keep")
    src = src.replace("if (q + 1 < chunks)", "if (LOAD_W && q + 1 < chunks)")
    return ("#ifndef GATE\n#define GATE gelu_exact\n#endif\n"
            "#ifndef LOAD_W\n#define LOAD_W 1\n#endif\n" + src)


VARIANTS = {"full": [], "no_a": ["-DNO_A"], "no_b": ["-DNO_B"], "no_c": ["-DNO_C"],
            "no_erf": ["-DGATE="], "no_w": ["-DLOAD_W=0"],
            "none": ["-DNO_A", "-DNO_B", "-DNO_C", "-DLOAD_W=0"]}


def build(out_dir) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "gdfn_variants.cu"
    src.write_text(variant_source())
    nvcc = _cuda._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC), *flags,
         "-o", str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).rpeflow_gdfn
        fn.argtypes, fn.restype = _cuda._SIGNATURES["rpeflow_gdfn"]
        libs[name] = fn
    return libs


def median_ms(fn, runs=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("gdfn_phases needs a CUDA device", file=sys.stderr)
        return 1
    libs = build(_cuda.BUILD_ROOT.parent / "gdfn_phases")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for b, h, w, c in SHAPES:
        hid = int(2.66 * c)
        x = torch.randn(b, h, w, c, generator=g, device=dev)
        w_in = torch.randn(c, 2 * hid, generator=g, device=dev) / c ** 0.5
        w_dw = torch.randn(3, 3, 2 * hid, generator=g, device=dev) / 3
        w_out = torch.randn(hid, c, generator=g, device=dev) / hid ** 0.5
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), w_in.data_ptr(), w_dw.data_ptr(), w_out.data_ptr(), out.data_ptr(),
                b, h, w, c, hid, stream)
        row = {name: median_ms(lambda: fn(*args)) for name, fn in libs.items()}
        print(f"gdfn phases {(b, h, w, c)}: " + "  ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
