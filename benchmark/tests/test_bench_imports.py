"""What the benchmark loads and where it writes.

* A run (the harness, at a tiny size on the CPU, eval and train, traced and
  not) leaves no module of JAX or of the JAX package in ``sys.modules``,
  compared by whole top-level names (``rpeflow_tpu_torch`` begins with
  ``rpeflow_tpu``).
* The reference and the yardstick (``benchmark/reference``,
  ``benchmark/lib``, ``benchmark/check.py``, the metric readers) load
  nothing of the program, and the benchmark's sources import of the program
  only its entry points.
* The sources name no fixed path outside the checkout (``/tmp``,
  ``/dev/shm``); the kernel caches are set inside it.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness, run

BENCH = Path(harness.__file__).resolve().parent
ENTRY_POINTS = {"rpeflow_tpu_torch", "rpeflow_tpu_torch.model",
                "rpeflow_tpu_torch.train.optim", "rpeflow_tpu_torch.train.state",
                "rpeflow_tpu_torch.train.evaluator"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(*parts):
    return [p for part in parts for p in ((BENCH / part).rglob("*.py") if (BENCH / part).is_dir()
                                          else [BENCH / part])]


def child(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    loaded = child(
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.tests.tiny_cells import tiny_cell, run\n"
        "for name, trace in (('ft3d_eval', False), ('dsec_finetune', True)):\n"
        "    run(tiny_cell(name), trace=trace, seconds=0.2)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert "rpeflow_tpu_torch.model" in loaded
    assert not [m for m in loaded if m.split(".")[0] in harness.FORBIDDEN]


def test_the_yardstick_loads_nothing_of_the_program():
    loaded = child(
        "import json, sys, pathlib, importlib.util\n"
        "import benchmark.check, benchmark.lib.profile, benchmark.reference.train\n"
        "for p in pathlib.Path('benchmark/metrics').glob('*.py'):\n"
        "    s = importlib.util.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert "benchmark.reference.model.core" in loaded
    assert not [m for m in loaded if m.split(".")[0].startswith("rpeflow_tpu")
                or m.split(".")[0] in harness.FORBIDDEN]
    for path in sources("reference", "lib", "metrics", "check.py"):
        assert not [m for m in imports(path) if m.split(".")[0].startswith("rpeflow_tpu")
                    or m.split(".")[0] in harness.FORBIDDEN], path


def test_the_harness_imports_only_the_entry_points():
    for path in sources("."):
        if "tests" in path.parts:
            continue
        named = {m for m in imports(path) if m.split(".")[0].startswith("rpeflow_tpu")}
        assert named <= ENTRY_POINTS, (path, named)
        assert not {m for m in imports(path) if m.split(".")[0] in harness.FORBIDDEN}


def test_no_fixed_paths_outside_the_checkout():
    for path in sources("."):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path
    assert run.CACHE.is_relative_to(harness.ROOT)
    from rpeflow_tpu_torch.ops import _cuda  # the program's own nvcc build directory

    assert _cuda.BUILD_ROOT == harness.ROOT / "build" / "torch_kernels"
