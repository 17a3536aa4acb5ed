"""BENCHMARK.json and the files it names: found by name and well formed."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark.harness import Cell, applies, load_module

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells at this length fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    for group, n_max in (("configs", 24), ("workloads", 24), ("end_to_end", 16),
                         ("per_layer", 128)):
        names = [e["name"] for e in BENCH[group]]
        assert 1 <= len(names) <= n_max and len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and line(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for m in METRICS:
        extra = {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"}
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert applies(e2e[m["moves"]], cell)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_set_up_a_rate_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(m, cell) for m in BENCH["per_layer"])


def test_configs_are_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert Path(c["file"]) == Path("benchmark/configs") / f"{c['name']}.json"
        data = json.loads((REPO / c["file"]).read_text())
        assert line(data["source"])
        assert set(data["reduced"]) == set(c["reduced"])
        assert data["guarantees"] and data["assumed"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    assert line(c.spec["why"])
    assert set(c.workload) <= {"entry", "argv", "index_argv"}
    importlib.import_module(f"benchmark.traffic.{c.mix['generator']}").make
    for name in ("prepare", "call", "after_call", "work", "reference",
                 "program_output", "as_output", "judge", "compare", "notes"):
        assert callable(getattr(c.entry_module.Entry, name))
    for m in c.per_layer:
        assert callable(c.metrics[m["name"]].read)
    for m in c.end_to_end:
        assert callable(c.readers[m["name"]].read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_file_reads_nothing_from_no_records(metric):
    mod = load_module(REPO / "benchmark" / "metrics" / f"{metric}.py", "m")
    assert mod.read({"calls": [], "kernels": {}, "device": None}) is None
    for span in getattr(mod, "SPANS", []):
        assert span["kind"] in ("call", "iter", "kernel") and ":" in span["target"]
        assert span["kind"] != "kernel" or callable(span["bound"])


def test_files_under_paths_are_named_from_name_characters():
    for p in (REPO / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
