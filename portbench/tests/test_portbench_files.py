"""Every configuration, traffic mix, workload and metric of BENCHMARK.json
loads by name, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from portbench.spec import HERE, ROOT, load_benchmark, load_cell, metric_reader

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) for k in cfg["reduced"]) and len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_loads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] in (1, 4)
    cell = load_cell(w["name"])
    cell.table_text()
    assert cell.reference_family() and cell.driver()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert callable(metric_reader(m["name"]))
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = e2e[m["moves"]]
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_files_named_from_names():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
