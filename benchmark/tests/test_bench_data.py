"""A later cell, configuration, traffic mix and per-layer metric are data: in
a copy of the benchmark, new files and new ``BENCHMARK.json`` entries alone
give a cell that the harness resolves and runs (here at a tiny size on the
CPU, traced), with the new metric's reader in its result."""

import json
import shutil

import torch

from benchmark import harness
from benchmark.tests.tiny_cells import CPU, SEED, tiny_config

READER = '''"""Traced iterations (a reader added as data)."""

UNIT = "iterations"
LAYER = "step"
MOVES = "eval_pairs_per_s"


def read(t):
    return float(t.iterations)
'''


def test_new_cell_and_metric_are_data(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    b = tmp_path / "benchmark"
    config = tiny_config(json.loads((b / "configs" / "ft3d.json").read_text()))
    config["name"] = "ft3d_tiny"
    (b / "configs" / "ft3d_tiny.json").write_text(json.dumps(config))
    (b / "traffic" / "eval_b2.json").write_text(json.dumps(
        {"mode": "eval", "batch": 2, "pool": 3, "warmup": 1, "sample": 2, "traced": 1}))
    (b / "limits" / "ft3d_tiny_eval.json").write_text(
        (b / "limits" / "ft3d_eval.json").read_text())
    (b / "metrics" / "traced_iterations.eval.py").write_text(READER)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ft3d_tiny", "source": "https://github.com/danqu130/RPEFlow",
                            "file": "benchmark/configs/ft3d_tiny.json", "reduced": [],
                            "why": "tiny"})
    spec["workloads"].append({"name": "ft3d_tiny_eval", "config": "ft3d_tiny",
                              "traffic": "eval_b2", "chips": 1, "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ft3d_eval" in m.get("workloads", []):
            m["workloads"].append("ft3d_tiny_eval")
    spec["per_layer"].append({"name": "traced_iterations.eval", "unit": "iterations",
                              "better": "higher", "source": "program_counter", "layer": "step",
                              "moves": "eval_pairs_per_s", "workloads": ["ft3d_tiny_eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("ft3d_tiny_eval", tmp_path)
    assert cell.shape == {"b": 2, "h": 64, "w": 64, "n": 256, "event_ch": 20}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "eval_pairs_per_s",
                                                     "eval_batch_ms_p90"]
    assert "traced_iterations.eval" in [m["name"] for m in cell.per_layer]
    torch.set_num_threads(1)
    result = harness.run(cell, SEED, 0.2, True, CPU, 0.0)
    assert result["correct"] is True
    assert result["metrics"]["traced_iterations.eval"] == {"value": 1.0, "unit": "iterations"}
