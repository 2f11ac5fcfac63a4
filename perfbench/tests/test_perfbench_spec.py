"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, traffic mix, route and metric by name."""

import json
import re

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                 "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")  # ASCII letters only: "us", not "µs"


def valid_unit(unit):
    return bool(UNIT.match(unit))


def test_top_level_keys_and_sizes():
    assert set(BENCH) == CONTRACT_KEYS
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_command_and_paths_stay_inside():
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert ONE_LINE.match(word) and not word.startswith("/") and ".." not in word
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path) and not path.endswith("_torch")
        assert (spec.ROOT / path).is_dir()


@pytest.mark.parametrize("name", [e["name"] for part in ("configs", "workloads", "end_to_end",
                                                         "per_layer") for e in BENCH[part]])
def test_name_rule(name):
    assert spec.valid_name(name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert valid_unit(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    per_layer = metric in BENCH["per_layer"]
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"layer", "moves"} if per_layer else {"bound"}
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if per_layer:
        assert ONE_LINE.match(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        # every cell that reads this metric reports the metric it moves
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_unit_rule_refuses_spaces_and_greek():
    assert valid_unit("samples/s") and valid_unit("%")
    assert not valid_unit("tokens per second") and not valid_unit("µs")
    assert not spec.valid_name("a b") and not spec.valid_name("a/b") and not spec.valid_name("")
    assert not spec.valid_name("x" * 65) and spec.valid_name("x" * 64)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"], BENCH)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and cell.chips == 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    c = spec.Cell(cell, BENCH)
    assert c.traffic["why"] and c.config["precision"] in ("f32", "bf16")
    assert ONE_LINE.match(c.entry["why"])
    assert hasattr(spec.load_route(c.traffic["route"]), "Route")
    assert set(c.traffic["limits"])
    assert c.traffic["rate_metric"] in {m["name"] for m in c.end_to_end}


def test_config_files_carry_their_source_and_cut():
    for entry in BENCH["configs"]:
        cfg = spec.load_config(entry["file"])
        assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
        assert entry["file"].startswith("perfbench/") and cfg["source"] and cfg["deployment"]
        assert ONE_LINE.match(entry["source"]) and ONE_LINE.match(entry["why"])


def test_every_per_layer_metric_has_a_reader_and_no_reader_is_orphaned():
    files = spec.metric_files()
    assert set(files) == {m["name"] for m in BENCH["per_layer"]}
    for name in files:
        assert callable(spec.load_metric(name).read)


def test_at_most_a_quarter_of_cells_on_four_chips():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
