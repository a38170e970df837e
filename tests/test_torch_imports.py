"""The port imports torch and never jax; its kernel wrappers take the plain
path for CPU tensors without building or counting a kernel launch."""

import subprocess
import sys

import numpy as np
import torch

_PROBE = """
import importlib, pkgutil, sys
import rpeflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rpeflow_tpu_torch.__path__, "rpeflow_tpu_torch.")
         if not m.name.rsplit(".", 1)[-1].startswith("eval_")]
for name in names:
    importlib.import_module(name)
print(len(names))
print(" ".join(m for m in ("jax", "flax", "yaml", "cv2", "h5py") if m in sys.modules))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          timeout=120, check=True)
    n_modules, leaked = (proc.stdout.splitlines() + [""])[:2]
    assert int(n_modules) >= 20
    assert leaked == "", f"importing the port pulled in: {leaked}"


def test_cpu_tensors_take_the_plain_path(rng):
    from rpeflow_tpu_torch.ops import _cuda, correlation, dwconv, fps, gdfn, mdta

    _cuda.reset_launch_counts()
    x = torch.from_numpy(rng.randn(1, 6, 7, 8).astype(np.float32))
    fps.furthest_point_sampling(torch.from_numpy(rng.randn(1, 20, 3).astype(np.float32)), 5)
    correlation.correlation2d(x, x, 4)
    mdta.mdta_qkv(x, x, torch.ones(4, 8), torch.ones(3, 3, 24), 3)
    gdfn.gdfn(x, torch.ones(8, 10), torch.ones(3, 3, 10), torch.ones(5, 8))
    dwconv.dwconv(x, torch.ones(3, 3, 8))
    dwconv.dwconv_taps_grad(x, x, 3)
    assert _cuda.LAUNCHES == {"fps": 0, "correlation2d": 0, "mdta_qkv": 0, "gdfn": 0,
                              "dwconv": 0}
    assert _cuda._lib is None, "a CPU call must not build or load the kernel library"
