"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import os
import re

import pytest

from benchmark.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = Manifest().spec


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group, keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_just_the_contracts_keys(group, keys):
    for entry in SPEC[group]:
        extra = set(entry) - keys
        assert set(entry) >= keys and extra <= {"workloads"}, (entry["name"], extra)
        assert NAME.match(entry["name"]), entry["name"]


def test_names_units_and_lines():
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in SPEC[g]]
    assert len(names) == len(set(names))
    for g in ("end_to_end", "per_layer"):
        for m in SPEC[g]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])
    for c in SPEC["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4)


def test_setup_s_is_there_with_its_bound():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_cell_finds_its_files_by_name():
    man = Manifest()
    pairs = set()
    for w in SPEC["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg, mix = man.config(w), man.mix(w)
        assert cfg["name"] == w["config"]
        assert man.client(mix).__name__ == "Client"
        e2e = man.end_to_end(w)
        layer = man.per_layer(w)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for reader, unit in man.readers(e2e + layer).values():
            assert callable(reader.read) and UNIT.match(unit)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, f))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    man = Manifest()
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] == "frames_per_s"
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in man.end_to_end(cells[cell])}


def test_layers_are_named_alike_and_configs_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_config_files_hold_the_released_widths():
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert c["reduced"] == []
        v, lm = cfg["model"]["vision"], cfg["model"]["lm"]
        assert (v["hidden_size"], v["intermediate_size"], v["num_layers"], v["num_heads"]) == (
            1152, 4304, 27, 16)
        assert (lm["hidden_size"], lm["intermediate_size"], lm["num_layers"], lm["num_heads"],
                lm["num_kv_heads"], lm["head_dim"]) == (3584, 18944, 28, 28, 4, 128)
        assert cfg["check"] and all(v > 0 for v in cfg["check"].values())
