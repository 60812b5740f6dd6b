"""BENCHMARK.json against the contract it is written to, and against the
files under portbench/ that it names."""
import json
import re

import pytest
from conftest import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = M["end_to_end"] + M["per_layer"]


def cells_of(metric):
    return metric.get("workloads", [w["name"] for w in M["workloads"]])


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"] and M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names_and_short_fields(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (M["configs"], M["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(cells_of(metric)) <= {w["name"] for w in M["workloads"]}
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("metric", M["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    moved = {m["name"]: m for m in M["end_to_end"]}[metric["moves"]]
    assert set(cells_of(metric)) <= set(cells_of(moved))
    if "roofline" in metric["name"]:
        assert metric["unit"] == "%"


def four_chip_cells_allowed(manifest: dict) -> bool:
    """The driver's rule: at most a quarter of the cells, rounded down, ask
    for four chips, and one always may."""
    cells = manifest["workloads"]
    return sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_each_cell(cell):
    assert cell["chips"] in (1, 4)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    e2e = [m["name"] for m in M["end_to_end"] if cell["name"] in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in cells_of(m) for m in M["per_layer"])
    params = json.loads((ROOT / "portbench" / "workloads" / f"{cell['name']}.json").read_text())
    assert (params["config"], params["traffic"]) == (cell["config"], cell["traffic"])
    assert (ROOT / "portbench" / "traffic" / f"{params['op']}.py").exists()


PLACED = {"name": "rr16-archive-placed-4chip", "config": "rapidraid-16-11",
          "traffic": "archive-placed-16", "chips": 4,
          "why": "16 objects a call over 16 nodes placed four to a card in chain order"}


def cells(chips):
    """Synthetic cells, one per entry of ``chips``."""
    return [dict(PLACED, name=f"cell-{i}", traffic=f"mix-{i}", chips=c)
            for i, c in enumerate(chips)]


@pytest.mark.parametrize("workloads,allowed", [
    (M["workloads"], True),
    (M["workloads"] + [PLACED], True),              # 1 of 4
    ([PLACED], True),                               # one always may
    (cells([4, 4]), False),
    (M["workloads"] + [PLACED, dict(PLACED, name="rr16-restore-placed-4chip")], False),
    (cells([1] * 6 + [4, 4]), True),                # 2 of 8
    (cells([1] * 5 + [4, 4, 4]), False),            # 3 of 8
    (cells([1] * 11 + [4]), True),                  # 1 of 12
], ids=["manifest", "manifest+placed", "placed-alone", "two-of-two", "two-of-five",
        "two-of-eight", "three-of-eight", "one-of-twelve"])
def test_four_chip_cells_within_the_rule(workloads, allowed):
    assert four_chip_cells_allowed({"workloads": workloads}) is allowed
    assert all(w["chips"] in (1, 4) for w in workloads)


def test_pairs_once_and_every_config_used():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in M["configs"]} == {w["config"] for w in M["workloads"]}


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/configs/")
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["source"] == config["source"]
    assert (ROOT / "portbench" / "reference" / f"{cfg['reference']}.py").exists()
    assert isinstance(cfg["l"], int) and cfg["l"] in (8, 16)
    assert isinstance(cfg["block_words"], int) and cfg["block_words"] > 0
    assert cfg["block_words"] * cfg["l"] // 8 % 8 == 0    # blocks fill 64-bit draws
    assert 0 < cfg["k"] < cfg["n"]


def test_files_under_paths_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
