"""BENCHMARK.json against the files it names, and the metric assembly
against what each cell declares: for every cell and role, synthetic
readings in, exactly the declared metrics out."""

import json
import os

import pytest

from portbench import harness

BENCH = harness.manifest()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")


def readings(cell: str) -> dict:
    """Readings of the kind a run of ``cell`` collects, made up."""
    name = harness.cell_of(BENCH, cell)["traffic"]
    traffic = harness.load_json(harness.HERE, "traffic", f"{name}.json")
    base = {"setup_s": 30.0, "window_s": 20.0, "device_window_s": 19.9,
            "busy_s": 18.0}
    if traffic["driver"] == "train_step":
        return {**base, "kind": "train", "steps": 70, "batch": 8,
                "enqueue_ms": [260.0, 262.0, 261.0],
                "flops_per_step": 37.3e12}
    return {**base, "kind": "serve", "requests": 16000,
            "latency_s": [0.03, 0.04, 0.05],
            "stats": {"batches": 1000, "padded_rows": 4000,
                      "images_done": 16000, "rows": 20000,
                      "histogram": {16: 500, 32: 500}},
            "flops_per_request": 142e9,
            "conv3x3": {"bound_s": 0.7, "device_s": 1.0}}


@pytest.mark.parametrize("role", ["e2e", "layer"])
@pytest.mark.parametrize("cell", CELLS)
def test_emitted_keys_equal_declared(cell, role):
    out = {"readings": readings(cell), "attempted": 1, "failed": 0,
           "memory_peak_bytes": 1, "checks": {}}
    if role == "layer":
        out["timer"] = {"window_s": 19.9, "intervals": [(0.0, 18.0)]}
    line = harness.result_line(BENCH, cell, role == "layer", out, {})
    assert set(line["metrics"]) == set(harness.declared(BENCH, cell, role))
    assert harness.line_faults(BENCH, cell, role, line) == []
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_missing_metric_is_named(cell):
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {"busy_s": 2.0, "window_s": 1.0}}
    faults = harness.line_faults(BENCH, cell, "layer", line)
    for name in harness.declared(BENCH, cell, "layer"):
        assert f"metric {name} missing" in faults
    assert any("busy_s" in f for f in faults)


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]


def test_names_and_units_use_allowed_characters():
    for name in _names():
        assert name[0].isalnum() or name[0] == "_"
        assert len(name) <= 64 and set(name) <= NAME_CHARS, name
    for cell in BENCH["workloads"]:
        for key in ("config", "traffic"):
            assert set(cell[key]) <= NAME_CHARS
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16
        assert set(m["unit"]) <= UNIT_CHARS, m["unit"]
        assert m["better"] in ("lower", "higher")
    names = list(_names())
    assert len(names) == len(set(names))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in harness.declared(BENCH, cell, "e2e"), \
                (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = harness.declared(BENCH, cell, "e2e")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.declared(BENCH, cell, "layer")


def test_files_named_by_the_manifest_exist():
    root = harness.ROOT
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(root, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for cell in BENCH["workloads"]:
        traffic = harness.load_json(harness.HERE, "traffic",
                                    f"{cell['traffic']}.json")
        assert os.path.exists(os.path.join(
            harness.HERE, "drivers", f"{traffic['driver']}.py"))
        limits = harness.load_json(harness.HERE, "limits",
                                   f"{cell['name']}.json")
        assert limits and all(v >= 0 for v in limits.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_paths_hold_the_command_and_the_files():
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
