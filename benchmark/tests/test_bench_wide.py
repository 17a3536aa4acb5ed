"""The wide build-graph cell (``build-graph.k55.pao1-30x``) on the CPU: its
metric files read nothing where a program lacks their scope or counter,
the wide batch step's bound at the cell's size, and whole runs of the cell
at a small size on the port's CPU path, with its control."""

import json
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.controls import control_numbers
from benchmark.harness import load_module
from benchmark.metrics import _wide
from benchmark.roofline import PEAK_BYTES_PER_S

REPO = Path(__file__).resolve().parents[2]
CELL = "build-graph.k55.pao1-30x"
# ~51k classes, below the growth spill of the first cap (131,072 lanes at
# this chunk): the cell's calls must not spill
SMALL = {"config": {"genome_length": 20_000, "coverage": 10},
         "traffic": {"reads_with_n": 5}, "argv": ["--chunk-size", "8192"]}
METRICS = ["reader_s.wide", "engine_add_s.wide", "flush_s.wide",
           "engine_finish_s.wide", "expand_s.wide", "d2h_gib.wide",
           "graph_write_s.wide", "wide_flush_roofline.wide",
           "device_idle_pct.wide", "call_median_s.wide"]
# what a call of a program without the wide engine's scopes records
OLDER = {"wall_s": 5.0, "spans": {}, "phases": {"stream": 1.0},
         "profile": {"count/read": 0.5, "count/add_chunk": 2.0,
                     "count/finish": 1.0, "graph/write": 1.0}}


def metric(name):
    return load_module(REPO / "benchmark" / "metrics" / f"{name}.py", "m")


def test_the_cell_lists_the_new_metrics():
    assert {m["name"] for m in harness.Cell(CELL).per_layer} == set(METRICS)


@pytest.mark.parametrize("name", [n for n in METRICS if n != "call_median_s.wide"])
def test_metric_reads_nothing_without_its_scope_or_counter(name):
    bare = {"wall_s": 5.0, "spans": {}, "phases": {}, "profile": {}}
    assert metric(name).read({"calls": [bare], "kernels": {}, "device": None}) is None
    # the scopes and counters that are new with the wide engine's tracing
    older = {"calls": [OLDER, OLDER], "kernels": {}, "device": None}
    if name in ("flush_s.wide", "expand_s.wide", "d2h_gib.wide"):
        assert metric(name).read(older) is None


def test_metrics_read_the_wide_scopes():
    prof = {**OLDER["profile"], "count/add_chunk/wide/flush": 0.75,
            "count/finish/flush_tail/wide/flush": 0.25,
            "count/finish/expand": 0.125, "count/finish/expand/sync": 0.0625,
            "#d2h_bytes": 3 * 2 ** 30}
    records = {"calls": [{**OLDER, "profile": prof}], "kernels": {},
               "device": None}
    got = {n: metric(n).read(records) for n in METRICS}
    assert got["flush_s.wide"] == 1.0 and got["expand_s.wide"] == 0.125
    assert got["d2h_gib.wide"] == 3.0 and got["reader_s.wide"] == 0.5
    assert got["call_median_s.wide"] == 5.0
    assert got["wide_flush_roofline.wide"] is None  # no device time: no number


def test_the_flush_bound_at_the_cell_size():
    from gossamer_tpu_torch.cmds.basic import wide_sizing

    cap, batch, fits = wide_sizing(16, 1 << 22)
    assert (cap, batch, fits) == (88_749_041, 8, True)
    codes = batch * ((1 << 22) + 55)
    n = _wide.flush_bytes(cap, codes, cap)
    assert n == 24 * 2 * 88_749_041 + 33_554_872 == 4_293_508_840
    assert abs(n / PEAK_BYTES_PER_S - 1.2816e-3) < 1e-6

    class Lanes:
        def __init__(self, n, cols=None):
            self.shape = (n, cols)

        def numel(self):
            return self.shape[0] * (self.shape[1] or 1)

    spec = Lanes(cap)
    assert _wide.flush_bound(Lanes(batch, (1 << 22) + 55), spec, spec, spec,
                             56, "value", cap) == n / PEAK_BYTES_PER_S


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_port_cpu_path_is_correct(trace, tmp_path):
    result = harness.run(CELL, 2 ** 31 + 55, 0.5, trace, device="cpu",
                         workdir=tmp_path / "w", overrides=SMALL)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["edges_mismatched"] == {"value": 0, "limit": 0}
    if trace:
        # every metric but the device's, which the CPU never gives
        assert set(result["metrics"]) == set(METRICS) - {
            "wide_flush_roofline.wide", "device_idle_pct.wide"}
    else:
        assert set(result["metrics"]) == {"build_graph_mbp_per_s",
                                          "peak_device_gib", "setup_s"}
    json.dumps(result)


def test_the_control_fails(tmp_path):
    got = control_numbers(harness.Cell(CELL, SMALL), 7, tmp_path / "c", "cpu")
    assert got["checks"]["edges_mismatched"]["value"] > 0
