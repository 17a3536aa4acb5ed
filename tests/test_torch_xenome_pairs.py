"""``xenome classify --pairs`` of the port against the benchmark's plain
pair reference (``benchmark/reference/xenome_pairs.py``: a pair's class is
that of the OR of its mates' class bits), on mate pairs of the benchmark's
own generator at a small size (references of 20 kbp, 2,000 pairs, 2% of
them discordant).  Each of the ten class files must hold exactly what the
reference puts there; the profile's pair scope and counters must read what
the reference counts; a pair rule of mate 1 alone must be caught."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries.xenome_classify import misclassified
from benchmark.reference.kmers import window_keys
from benchmark.reference.xenome import index
from benchmark.reference.xenome_pairs import classes_of_bits, pair_classes, read_bits
from benchmark.traffic import xenograft_pairs
from benchmark.traffic._seqio import fastq_records
from gossamer_tpu_torch.cli.xenome import main as xenome_main
from gossamer_tpu_torch.utils import profile

REPO = Path(__file__).resolve().parents[1]
K = 25
PAIRS = 2_000
SMALL = {"graft_length": 20_000, "host_length": 20_000, "segment_at": 5_000,
         "segment_length": 2_000, "sample_pairs": PAIRS}
# reference.xenome.CLASSES, the graft and host under the names given
NAMES = ("neither", "both", "ambiguous", "human", "mouse")
HALVES = ("1", "2")


def call(argv, profiled: bool):
    """-> (stdout, the profile's totals or None)."""
    profile.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert xenome_main(argv + (["-D", "print-profile"] if profiled else [])) == 0
    totals = profile.totals() if profiled else None
    profile.reset()
    return out.getvalue(), totals


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xenome_pairs")
    config = {**json.loads((REPO / "benchmark/configs/xenome-pdx-pairs-k25.json")
                           .read_text()), **SMALL}
    mix = json.loads((REPO / "benchmark/traffic/pdx-pairs-fastq.json").read_text())
    inp = xenograft_pairs.make(config, mix, 2 ** 31 + 2323, tmp)
    call(["index", "-K", str(K), "-G", inp["graft_fasta"], "-H",
          inp["host_fasta"], "-P", str(tmp / "idx"), "--device", "cpu"], False)
    runs = {}
    for mode, profiled in (("pairs", True), ("pairs-off", False), ("single", True)):
        reads = (["--pairs", "-i", inp["reads_1_fastq"], "-i", inp["reads_2_fastq"]]
                 if mode != "single" else ["-i", inp["reads_1_fastq"]])
        prefix = tmp / mode
        stats, totals = call(["classify", "-P", str(tmp / "idx"), *reads,
                              "--graft-name", "human", "--host-name", "mouse",
                              "--output-filename-prefix", str(prefix),
                              "--device", "cpu"], profiled)
        files = {p.name[len(prefix.name) + 1:]: p.read_bytes()
                 for p in sorted(tmp.glob(prefix.name + "_*"))}
        runs[mode] = (stats, totals, files)
    keys, cls = index(inp["graft"], inp["host"], K, "cpu")
    bits = {h: read_bits(inp[f"reads_{h}"], keys, cls, K, "cpu") for h in HALVES}
    return inp, runs, bits


def files_of_classes(inp, classes) -> dict[str, bytes]:
    """The ten class files that hold each pair in the files of ``classes``."""
    out = {}
    for h in HALVES:
        records = fastq_records(inp[f"reads_{h}"])
        for c, name in enumerate(NAMES):
            out[f"{name}_{h}.fastq"] = records[classes == c].tobytes()
    return out


def valid_windows(reads: np.ndarray) -> int:
    return int(window_keys(torch.from_numpy(reads), K)[1].sum())


@pytest.mark.parametrize("half", HALVES)
def test_each_half_equals_the_plain_pair_reference(world, half):
    inp, runs, bits = world
    want = files_of_classes(inp, pair_classes(bits["1"], bits["2"]))
    for mode in ("pairs", "pairs-off"):
        got = runs[mode][2]
        assert sorted(got) == sorted(want)
        for name in want:
            if name.endswith(f"_{half}.fastq"):
                assert got[name] == want[name], (mode, name)
    # the statistics count pairs: 2,000 in the 16 rows of blrg
    assert sum(int(line.split("\t")[4])
               for line in runs["pairs"][0].splitlines()[2:18]) == PAIRS
    assert runs["pairs"][0] == runs["pairs-off"][0]


def test_pairs_split_counts_what_the_pair_rule_decides(world):
    inp, runs, bits = world
    t = runs["pairs"][1]
    split = int(np.count_nonzero(bits["1"] != bits["2"]))
    assert t["#pairs"] == PAIRS
    assert t["#pairs_split"] == split > 0
    # nearly every discordant pair's mates differ in class bits (a graft
    # mate inside the shared segment can match a segment mate)
    discordant = inp["sources"][:, 0] != inp["sources"][:, 1]
    assert (bits["1"] != bits["2"])[discordant].mean() > 0.9


def test_a_pair_rule_of_mate_1_alone_is_caught(world):
    inp, _runs, bits = world
    want = pair_classes(bits["1"], bits["2"])
    control = files_of_classes(inp, classes_of_bits(bits["1"]))
    bad = sum(misclassified({c: control[f"{name}_{h}.fastq"]
                             for c, name in enumerate(NAMES)},
                            fastq_records(inp[f"reads_{h}"]), want)
              for h in HALVES)
    assert bad > 0


@pytest.mark.parametrize("mode", ["pairs", "single"])
def test_the_pair_scope_and_the_join_counters(world, mode):
    inp, runs, _bits = world
    t = runs[mode][1]
    reads = [inp["reads_1"], inp["reads_2"]] if mode == "pairs" else [inp["reads_1"]]
    assert t["#join_windows"] == sum(valid_windows(r) for r in reads)
    assert 0 < t["#join_windows"] <= t["#join_lanes"]
    # one batch: its window is the reads' codes rounded up to a power of two
    n_codes = sum(r.size + len(r) for r in reads)
    assert t["#join_lanes"] == 1 << int(np.ceil(np.log2(n_codes)))
    assert {"classify/encode", "classify/pack", "classify/launch",
            "classify/wait"} <= set(t)
    if mode == "pairs":
        assert "classify/mates" in t and t["#pairs"] == PAIRS
    else:
        assert "classify/mates" not in t and "#pairs" not in t
