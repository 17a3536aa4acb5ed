"""The pinned share of the pulls to the host, ``d2h_pinned_pct.build`` and
``.wide``: 100 x ``#d2h_pinned_bytes`` / ``#d2h_bytes`` over the calls,
nothing where a program lacks the pinned counter (one older than it) or
pulled no bytes, each metric listed in its own build-graph cell alone."""

from pathlib import Path

import pytest

from benchmark import harness
from benchmark.harness import load_module

REPO = Path(__file__).resolve().parents[2]
CELLS = {"d2h_pinned_pct.build": "build-graph.k25.ecoli-30x",
         "d2h_pinned_pct.wide": "build-graph.k55.pao1-30x"}
OTHERS = ["xenome-classify.k25.pdx"]


def metric(name):
    return load_module(REPO / "benchmark" / "metrics" / f"{name}.py", "m")


def records(*profiles):
    return {"calls": [{"wall_s": 1.0, "spans": {}, "phases": {}, "profile": p}
                      for p in profiles],
            "kernels": {}, "device": None}


@pytest.mark.parametrize("name", list(CELLS))
def test_reads_nothing_without_the_pinned_counter(name):
    m = metric(name)
    assert m.read(records({})) is None
    # the parent's program: its pulls counted, none of them as pinned
    assert m.read(records({"#d2h_bytes": 2.0 ** 30}, {"#d2h_bytes": 5.0})) is None
    assert m.read(records({"#d2h_bytes": 0.0, "#d2h_pinned_bytes": 0.0})) is None


@pytest.mark.parametrize("name", list(CELLS))
def test_reads_the_pinned_share_of_the_pulled_bytes(name):
    m = metric(name)
    every = {"#d2h_bytes": 1684240384.0, "#d2h_pinned_bytes": 1684240384.0}
    assert m.read(records(every, every)) == 100.0
    half = {"#d2h_bytes": 4.0, "#d2h_pinned_bytes": 1.0}
    # means over the calls: (4 + 1) / (4 + 4)
    assert m.read(records(half, {"#d2h_bytes": 4.0,
                                 "#d2h_pinned_bytes": 4.0})) == 62.5


@pytest.mark.parametrize("name", list(CELLS))
def test_each_share_in_its_own_cell(name):
    for cell in [*CELLS.values(), *OTHERS]:
        listed = {m["name"] for m in harness.Cell(cell).per_layer}
        assert (name in listed) == (cell == CELLS[name])
