"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every configuration, traffic mix, driver and metric by name."""
import json
import re

import pytest

from portbench.harness import ROOT, driver, load_benchmark, load_cell, metric_reader, reader_path

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration(entry):
    assert entry["file"].startswith("portbench/configs/") and _line(entry["source"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])
    assert cfg["n_docs"] * cfg["shards"] >= cfg["published"]["n_docs"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    c = load_cell(cell, BENCH)
    assert c.workload["chips"] in (1, 4) and _line(c.workload["why"])
    drv = driver(c.traffic)
    for fn in ("prepare", "measure", "collect", "reference_rho", "work_bytes"):
        assert callable(getattr(drv, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # the metric it moves is one this cell reports
        assert m["moves"] in e2e
    limits = c.traffic["limits"]
    assert {"score_gap", "bad_answers"} <= set(limits)
    assert ("postings_off" in limits) == (c.traffic["engine"] == "saat")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    assert reader_path(metric["name"]).is_file()
    assert callable(metric_reader(metric["name"]).read)
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
