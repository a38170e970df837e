"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units, bounds and the files each entry names; every metric reader agrees
with its entry."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert all(one_line(w) for w in SPEC["command"]) and len(SPEC["command"]) <= 32
    assert SPEC["paths"] == ["benchmark"]
    assert all(PATH.fullmatch(p) and ".." not in p for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), [n for n in names if not NAME.fullmatch(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in SPEC[key]]
        assert len(seen) == len(set(seen))
    units = [m["unit"] for key in ("end_to_end", "per_layer") for m in SPEC[key]]
    assert all(UNIT.fullmatch(u) for u in units), units


def test_configs_and_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert {c["name"] for c in SPEC["configs"]} == used
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and c["source"].startswith("https://")
        config = json.loads((harness.ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and c["file"].startswith("benchmark/configs/")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        cell = harness.load_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert [m["name"] for m in cell.end_to_end][0] == "setup_s"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_metrics():
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_agrees_with_entry(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    reader = harness.load_cell(entry["workloads"][0]).reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"],
                                                        entry["moves"])
