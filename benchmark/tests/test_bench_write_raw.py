"""The raw share of the class files' records, ``write_raw_pct.classify``:
100 x ``#write_raw`` / (``#write_raw`` + ``#write_formatted``) over the
calls, nothing where a program lacks the counters (one older than them),
listed in the two classify cells alone; a traced run of each at a small
size on the port's CPU path reads 100.0 on the generator's records."""

from pathlib import Path

import pytest

from benchmark import harness
from benchmark.harness import load_module
from benchmark.tests.sizes import CLASSIFY, SMALL

REPO = Path(__file__).resolve().parents[2]
NAME = "write_raw_pct.classify"
PAIRS = "xenome-classify.k25.pdx-pairs"
CELLS = {CLASSIFY: SMALL[CLASSIFY],
         PAIRS: {"config": {"graft_length": 20_000, "host_length": 20_000,
                            "segment_at": 5_000, "segment_length": 2_000,
                            "sample_pairs": 1_500}}}
OTHERS = ["build-graph.k25.ecoli-30x", "build-graph.k55.pao1-30x"]


def metric():
    return load_module(REPO / "benchmark" / "metrics" / f"{NAME}.py", "m")


def records(*profiles):
    return {"calls": [{"wall_s": 1.0, "spans": {}, "phases": {}, "profile": p}
                      for p in profiles],
            "kernels": {}, "device": None}


def test_reads_nothing_without_the_counters():
    m = metric()
    assert m.read(records({})) is None
    # the parent's program: its scopes, no write counters
    assert m.read(records({"xenome/write": 1.1, "classify/read": 1.6})) is None
    assert m.read(records({"#write_raw": 0.0, "#write_formatted": 0.0})) is None


def test_reads_the_raw_share_of_the_records():
    m = metric()
    every = {"#write_raw": 250_000.0, "#write_formatted": 0.0}
    assert m.read(records(every, every)) == 100.0
    # means over the calls: (3 + 1) / (4 + 4)
    assert m.read(records({"#write_raw": 3.0, "#write_formatted": 1.0},
                          {"#write_raw": 1.0, "#write_formatted": 3.0})) == 50.0
    assert m.read(records({"#write_raw": 0.0, "#write_formatted": 7.0})) == 0.0


def test_listed_in_the_classify_cells_alone():
    for cell in [*CELLS, *OTHERS]:
        listed = {m["name"] for m in harness.Cell(cell).per_layer}
        assert (NAME in listed) == (cell in CELLS)


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_small_traced_run_writes_every_record_raw(cell, tmp_path):
    result = harness.run(cell, 2 ** 31 + 24, 0.5, True, device="cpu",
                         workdir=tmp_path / "w", overrides=CELLS[cell])
    assert result["correct"] is True, result["checks"]
    assert result["metrics"][NAME] == {"value": 100.0, "unit": "%"}
