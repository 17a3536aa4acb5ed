"""The yeast build-graph cell (``build-graph.k25.yeast-30x``) on the CPU: its
configuration and command are the E. coli cell's at another genome, the
metrics that list it, the two metrics of the count's spills and of the
finish's side, and a traced run of the cell at a small size on the port's
CPU path that spills several times and finishes on the host."""

import json
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.harness import load_module

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "build-graph.k25.yeast-30x"
ECOLI = "build-graph.k25.ecoli-30x"
NEW = ["spill_runs.build", "finish_card_pct.build"]
METRICS = [f"{n}.build" for n in (
    "reader_s", "engine_add_s", "engine_finish_s", "graph_write_s",
    "fold_roofline", "device_idle_pct", "call_median_s", "finish_decode_s",
    "finish_merge_s", "d2h_gib", "d2h_pinned_pct", "spill_s", "host_wait_s",
    "hist_s", "graph_make_s")] + NEW
# 2,000 reads in 25 chunks of 8192 windows, flushes of 8 chunks: a cap of
# 65,536 lanes spills at every flush but the last, and the finish's lanes
# pass half of it
SMALL = {"config": {"genome_length": 20_000, "coverage": 10},
         "traffic": {"reads_with_n": 5},
         "argv": ["--chunk-size", "8192", "--spectrum-cap", "65536"]}


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def metric(name):
    return load_module(REPO / "benchmark" / "metrics" / f"{name}.py", "m")


def records(*profiles):
    return {"calls": [{"wall_s": 1.0, "spans": {}, "phases": {}, "profile": p}
                      for p in profiles], "kernels": {}, "device": None}


def test_the_config_is_the_ecoli_config_at_another_genome():
    yeast, ecoli = config("goss-yeast-30x"), config("goss-ecoli-30x")
    assert set(yeast) == set(ecoli) and yeast["reduced"] == {}
    assert yeast["genome_length"] == 12_157_105
    for key in ("coverage", "read_length", "k", "buffer_gb", "chunk_windows",
                "threads", "guarantees"):
        assert yeast[key] == ecoli[key]
    entry = {c["name"]: c for c in BENCH["configs"]}["goss-yeast-30x"]
    assert entry["reduced"] == [] and "GCF_000146045.2" in entry["source"]


def test_the_command_is_the_ecoli_cells():
    yeast, ecoli = harness.Cell(CELL), harness.Cell(ECOLI)
    assert yeast.workload == ecoli.workload
    assert "-B" not in yeast.workload["argv"]  # the default -B 2
    assert yeast.mix == ecoli.mix and yeast.chips == 1


def test_the_cell_is_listed_by_its_metrics():
    cell = harness.Cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert "merge_roofline.build" not in {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} == {
        "build_graph_mbp_per_s", "peak_device_gib", "setup_s"}
    for name in NEW:
        listed = {m["name"]: m for m in BENCH["per_layer"]}[name]["workloads"]
        assert listed == [ECOLI, CELL]


@pytest.mark.parametrize("name", NEW)
def test_new_metric_reads_nothing_without_its_counters(name):
    older = {"count/read": 0.5, "spill": 0.25, "#d2h_bytes": 4.0}
    assert metric(name).read(records(older, older)) is None
    assert metric(name).read(records()) is None


def test_the_new_metrics_read_the_counters():
    host = {"#spill_runs": 8.0, "#finish_lanes": 130.0, "#finish_lanes_card": 0.0}
    card = {"#spill_runs": 1.0, "#finish_lanes": 30.0, "#finish_lanes_card": 30.0}
    spills, side = metric(NEW[0]), metric(NEW[1])
    assert spills.read(records(host, host)) == 8.0
    assert side.read(records(host, host)) == 0.0
    assert spills.read(records(card)) == 1.0
    assert side.read(records(card)) == 100.0
    # a program with the counters whose calls did not spill
    no_spill = {"#finish_lanes": 30.0, "#finish_lanes_card": 30.0}
    assert spills.read(records(no_spill)) == 0.0


def test_a_small_traced_run_spills_and_finishes_on_the_host(tmp_path):
    result = harness.run(CELL, 2 ** 31 + 25, 0.5, True, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["edges_mismatched"] == {"value": 0, "limit": 0}
    got = result["metrics"]
    assert got["spill_runs.build"]["value"] >= 2
    assert got["finish_card_pct.build"]["value"] == 0
    assert got["spill_runs.build"]["unit"] == "runs"
    # every metric but the device's and the pinned share of pulls from a
    # card, which the CPU never gives
    assert set(got) == set(METRICS) - {"fold_roofline.build",
                                       "device_idle_pct.build",
                                       "d2h_pinned_pct.build"}
    json.dumps(result)
