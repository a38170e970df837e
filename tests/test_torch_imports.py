"""The port imports torch and never jax, nor any module of the JAX package
``rpeflow_tpu``; its kernel wrappers take the plain path for CPU tensors
without building or counting a kernel launch."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import rpeflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rpeflow_tpu_torch.__path__, "rpeflow_tpu_torch.")
         if not m.name.rsplit(".", 1)[-1].startswith("eval_")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
print(" ".join(m for m in ("jax", "flax", "yaml", "cv2", "h5py") if m in sys.modules))
print(" ".join(m for m in sys.modules if m == "rpeflow_tpu" or m.startswith("rpeflow_tpu.")))
"""


@pytest.fixture(scope="module")
def probe():
    """Module names imported, third-party modules pulled in, and JAX-package
    modules pulled in by importing every module of the port (one process)."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                          timeout=120, check=True, cwd=REPO)
    return [line.split() for line in (proc.stdout.splitlines() + ["", "", ""])[:3]]


def test_port_imports_no_jax(probe):
    names, leaked, _ = probe
    assert len(names) >= 20
    assert leaked == [], f"importing the port pulled in: {leaked}"


def test_port_imports_its_own_host_layer(probe):
    names, _, _ = probe
    for mod in ("rpeflow_tpu_torch.data", "rpeflow_tpu_torch.data.loader",
                "rpeflow_tpu_torch.data.dsec", "rpeflow_tpu_torch.train.config",
                "rpeflow_tpu_torch.train.factory", "rpeflow_tpu_torch.compat"):
        assert mod in names, mod


def test_port_imports_its_parallel_modules(probe):
    names, _, _ = probe
    for mod in ("rpeflow_tpu_torch.parallel", "rpeflow_tpu_torch.parallel.mesh",
                "rpeflow_tpu_torch.parallel.dryrun"):
        assert mod in names, mod


def test_port_imports_its_bench_modules(probe):
    """The bench and the work, FLOP and profile modules it reads import
    with the rest, pulling in no JAX (checked above for all modules)."""
    names, _, _ = probe
    for mod in ("rpeflow_tpu_torch.bench", "rpeflow_tpu_torch.utils.work",
                "rpeflow_tpu_torch.utils.flops", "rpeflow_tpu_torch.utils.profile"):
        assert mod in names, mod


def test_port_imports_no_module_of_the_jax_package(probe):
    _, _, jax_pkg = probe
    assert jax_pkg == [], f"importing the port pulled in: {jax_pkg}"


def _port_sources():
    """chip_smoke.py, the package, and the port's scripts (scripts/torch_*.py)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "rpeflow_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_jax_package_import(path):
    """No ``import rpeflow_tpu...`` / ``from rpeflow_tpu...`` statement, at any
    depth of the file (function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [f"line {node.lineno}: {m}" for m in mods
                if m.split(".")[0] in ("rpeflow_tpu", "jax", "flax")]
    assert bad == [], bad


def test_cpu_tensors_take_the_plain_path(rng):
    from rpeflow_tpu_torch.ops import (_cuda, conv3x3, correlation, dwconv, fps, gather, gdfn,
                                       mdta, zero_store)

    _cuda.reset_launch_counts()
    x = torch.from_numpy(rng.randn(1, 6, 7, 8).astype(np.float32))
    fps.furthest_point_sampling(torch.from_numpy(rng.randn(1, 20, 3).astype(np.float32)), 5)
    correlation.correlation2d(x, x, 4)
    correlation.correlation2d_bwd(x, x, torch.ones(1, 6, 7, 81), 4)
    mdta.mdta_qkv(x, x, torch.ones(4, 8), torch.ones(3, 3, 24), 3)
    gdfn.gdfn(x, torch.ones(8, 10), torch.ones(3, 3, 10), torch.ones(5, 8))
    dwconv.dwconv(x, torch.ones(3, 3, 8))
    dwconv.dwconv_bwd(x, x, torch.ones(3, 3, 8))
    idx = torch.zeros(6, 5, dtype=torch.int32)
    gather.gather_rows(x[0], idx)
    gather.gather_lanes(x[0], idx)
    zero_store.zero_store(x, 3)
    conv3x3.conv3x3_nhwc(x, torch.ones(4, 8, 3, 3), torch.ones(4), 2)
    assert _cuda.LAUNCHES == {"fps": 0, "correlation2d": 0, "correlation2d_bwd": 0,
                              "mdta_qkv": 0, "gdfn": 0, "dwconv": 0, "gather_rows": 0,
                              "gather_lanes": 0, "zero_store": 0, "conv3x3": 0}
    assert _cuda._lib is None, "a CPU call must not build or load the kernel library"
