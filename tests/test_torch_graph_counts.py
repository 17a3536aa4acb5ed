"""build-graph's counts leave the device as the graph file holds them
(``ops/transfer.py`` ``file_counts``): narrowed to uint32 where every count
fits, with their histogram counted on the device (``#hist_card``) where
``count_hist`` would have counted it.  The graph files stay byte for byte
what the host's cast and ``count_hist`` write; every other caller of the
finishes and of ``Graph.write`` keeps int64 counts and the host's
histogram."""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from gossamer_tpu_torch.cli.goss import main as goss_main
from gossamer_tpu_torch.cli.xenome import main as xenome_main
from gossamer_tpu_torch.graph.graph import Graph, count_hist
from gossamer_tpu_torch.io.factory import (PhysicalFileFactory,
                                            StringFileFactory)
from gossamer_tpu_torch.ops import count as count_mod
from gossamer_tpu_torch.ops.transfer import (file_counts, file_counts_host,
                                             planes_to_host)
from gossamer_tpu_torch.utils import profile

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def profile_on():
    profile.reset()
    profile.enable()
    yield
    profile.enable(False)
    profile.reset()


def _counts(case: str) -> np.ndarray:
    rng = np.random.default_rng(22)
    small = rng.integers(1, 300, 999)
    return {
        "under_2^16": rng.integers(1, 1 << 16, 5000),
        "top_2^16_of_999": np.r_[small, 1 << 16],  # top == max(2^16, n)
        "top_n-1_of_70000": np.r_[rng.integers(1, 9, 69_999), 69_999],
        "top_n_of_70000": np.r_[rng.integers(1, 9, 69_999), 70_000],
        "at_least_2^31": np.r_[small, 1 << 31, (1 << 32) - 1],
        "at_least_2^32": np.r_[small, 1 << 32, 5 << 32],
        "negative": np.r_[small, -3],
        "empty": np.zeros(0, np.int64),
    }[case].astype(np.int64)


def _graph_files(counts, hist=None) -> dict:
    fac = StringFileFactory()
    lo = np.arange(len(counts), dtype=np.uint64)
    Graph(25, lo, lo, counts).write("g", fac, hist)
    return fac.files


CASES = ["under_2^16", "top_2^16_of_999", "top_n-1_of_70000",
         "top_n_of_70000", "at_least_2^31", "at_least_2^32", "negative",
         "empty"]


@pytest.mark.parametrize("case", CASES)
def test_file_counts_equal_the_host_cast_and_count_hist(case):
    c = _counts(case)
    dev_c, dev_hist = file_counts(torch.from_numpy(c.copy()))
    c_host, *hist_host = planes_to_host(dev_c, *dev_hist)
    counts, hist = file_counts_host(c_host, hist_host)
    top = int(c.max()) if len(c) else 0
    low = int(c.min()) if len(c) else 0
    if low < 0:  # left to the write, which casts and counts as before
        assert counts.dtype == np.int64 and hist is None
        assert np.array_equal(counts, c)
    else:  # the cast Graph.write makes
        want = c.astype(np.uint32) if top < 1 << 32 else c
        assert counts.dtype == want.dtype and np.array_equal(counts, want)
    counted = len(c) and 0 <= low and top < min(max(1 << 16, len(c)), 1 << 31)
    if len(c) == 0 or counted:
        want_hist = count_hist(counts, top)
        assert hist is not None
        for got, w in zip(hist, want_hist):
            assert got.dtype == w.dtype and np.array_equal(got, w)
    else:
        assert hist is None
    assert profile.totals().get("#hist_card", 0) == (1 if counted else 0)
    # what the write makes of them: the files of the int64 counts
    profile.enable(False)
    assert _graph_files(counts, hist) == _graph_files(c)


def test_write_with_a_histogram_reads_and_counts_nothing():
    counts = np.array([3, 1, 3, 7], np.uint32)
    hist = (np.array([1, 3, 7], np.uint32), np.array([1, 2, 1]))
    files = _graph_files(counts, hist)
    assert files["g-counts-hist.txt"] == b"1\t1\n3\t2\n7\t1\n"
    t = profile.totals()
    assert "#hist_counted" not in t and "#hist_sorted" not in t
    assert "graph/write/hist" in t
    assert files == _graph_files(counts.astype(np.int64))


# ------------------------------------------------------------ the CLI
def _fastq(path: Path, n: int, length: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 6_000)
    starts = rng.integers(0, len(genome) - length, n)
    path.write_text("".join(
        f"@r{i}\n{ACGT[genome[p:p + length]].tobytes().decode()}\n+\n"
        f"{'I' * length}\n" for i, p in enumerate(starts)))


def _run(main, argv) -> dict:
    profile.reset()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv + ["-D", "print-profile"]) == 0
    return profile.totals()


def _files(prefix: Path) -> dict:
    return {p.name[len(prefix.name):]: p.read_bytes()
            for p in sorted(prefix.parent.glob(prefix.name + "*"))}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_counts")
    _fastq(tmp / "reads.fq", 300, 150, 7)
    return tmp


@pytest.mark.parametrize("k", [25, 55])
def test_build_graph_counts_its_histogram_on_the_device(reads, k):
    """One flush, no spill: the finish expands on the device (the CPU
    here), and the files equal those of the count's int64 counts written
    by the host's cast and ``count_hist``."""
    out = reads / f"g{k}"
    t = _run(goss_main, ["build-graph", "-k", str(k), "-i",
                         str(reads / "reads.fq"), "-O", str(out),
                         "--chunk-size", "65536", "--device", "cpu"])
    assert t["#hist_card"] == 1
    assert "#hist_counted" not in t and "#hist_sorted" not in t
    assert t.get("#spill_runs", 0) == 0
    g = Graph.read(str(out), PhysicalFileFactory())
    assert g.counts.dtype == np.uint32
    lo, hi, c = count_mod.count_rho_mers_files(
        [str(reads / "reads.fq")], k + 1, both_strands=True, canonical=False,
        device=torch.device("cpu"), chunk=65536)
    assert c.dtype == np.int64
    profile.enable(False)
    fac = StringFileFactory()
    Graph(k, lo, hi, c).write("g", fac)
    assert {s: fac.files["g" + s] for s in _files(out)} == _files(out)


def test_restore_graph_takes_the_host_route(reads):
    built, restored = reads / "built", reads / "restored"
    _run(goss_main, ["build-graph", "-k", "25", "-i", str(reads / "reads.fq"),
                     "-O", str(built), "--chunk-size", "65536",
                     "--device", "cpu"])
    _run(goss_main, ["dump-graph", "-G", str(built), "-o",
                     str(reads / "dump.txt"), "--device", "cpu"])
    t = _run(goss_main, ["restore-graph", "-f", str(reads / "dump.txt"),
                         "-O", str(restored), "--device", "cpu"])
    assert t["#hist_counted"] == 1 and "#hist_card" not in t
    assert _files(restored) == _files(built)


@pytest.fixture
def counted(monkeypatch):
    """Every output of ``count_chunks`` while the fixture is in use."""
    outs = []
    real = count_mod.count_chunks

    def spy(*args, **kw):
        out = real(*args, **kw)
        outs.append(out)
        return out

    monkeypatch.setattr(count_mod, "count_chunks", spy)
    return outs


def test_other_counts_stay_int64(reads, counted):
    """build-kmer-set, xenome index and the sharded build-graph: three
    planes, int64 counts, the histogram on the host."""
    fq = str(reads / "reads.fq")
    _run(goss_main, ["build-kmer-set", "-k", "25", "-i", fq, "-O",
                     str(reads / "ks"), "--device", "cpu"])
    fa = reads / "ref.fa"
    rng = np.random.default_rng(3)
    fa.write_text(f">a\n{ACGT[rng.integers(0, 4, 2_000)].tobytes().decode()}\n")
    _run(xenome_main, ["index", "-K", "25", "-G", fq, "-H", str(fa), "-P",
                       str(reads / "idx"), "--device", "cpu"])
    assert len(counted) == 3
    for lo, hi, c in counted:
        assert c.dtype == np.int64 and len(c) > 0
    counted.clear()
    t = _run(goss_main, ["build-graph", "-k", "25", "-i", fq, "-O",
                         str(reads / "gs"), "--num-devices", "2",
                         "--chunk-size", "4096", "--spectrum-cap", "65536",
                         "--device", "cpu"])
    ((*_, c, hist),) = counted
    assert c.dtype == np.int64 and hist is None
    assert t["#hist_counted"] == 1 and "#hist_card" not in t
