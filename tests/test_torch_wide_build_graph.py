"""``goss build-graph -k 55`` of the port against the benchmark's plain
reference (``benchmark/reference/spectrum_wide.py``), and that reference
against a brute force over Python ints.

The port's graph is read back from its three files (both key planes and
the counts) and converted into the reference's halves as the benchmark's
entry does; every comparison is exact.  Reads: a seeded 20 kbp genome at
10x of 150 bp reads, as the benchmark's generator makes them, counted with
``--chunk-size 4096``.  The count's first cap, two flushes' lanes (65,536),
spills to grow once a check finds more than 32,768 live classes: the
generator's 0.5% substitutions give ~51k classes and spill so; 0.1% give
~27k, which never spill; ``--spectrum-cap`` forces spills besides.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.entries.goss_build_graph_wide import halves_from_planes
from benchmark.reference.spectrum_wide import (edge_spectrum_wide,
                                               mismatched_wide)
from benchmark.traffic._seqio import write_fastq
from benchmark.traffic.genome_reads import make_reads
from gossamer_tpu_torch.cli.goss import main as goss_main

K = 55
RHO = K + 1
BASES = "ACGT"


def spectrum_of_graph(base: str, rho: int):
    return halves_from_planes(np.load(base + ".edges-hi"),
                              np.load(base + ".edges-lo"), rho) + (
        torch.from_numpy(np.load(base + ".counts").astype(np.int64)),)


def count_line(log) -> str:
    return [l for l in log.read_text().splitlines() if "\tcount: " in l][0]


@pytest.mark.parametrize("case,sub_rate,reads_with_n,argv,spilled", [
    ("no spill", 0.001, 0, [], False),
    ("spills to grow the spectrum", 0.005, 0, [], True),
    ("spills under --spectrum-cap", 0.005, 0, ["--spectrum-cap", "49152"], True),
    ("reads with an N", 0.001, 20, [], False),
])
def test_port_graph_equals_the_reference(case, sub_rate, reads_with_n, argv,
                                         spilled, tmp_path):
    _genome, reads = make_reads(np.random.default_rng(55), genome_len=20_000,
                                coverage=10, read_len=150, sub_rate=sub_rate,
                                n_with_n=reads_with_n)
    write_fastq(tmp_path / "reads.fastq", reads)
    base, log = str(tmp_path / "graph"), tmp_path / "call.log"
    assert goss_main(["build-graph", "-k", str(K), "-i", str(tmp_path / "reads.fastq"),
                      "-O", base, "-l", str(log), "--device", "cpu",
                      "--chunk-size", "4096", *argv]) == 0
    line = count_line(log)
    assert (" 0 spills" not in line) == spilled, line
    got = spectrum_of_graph(base, RHO)
    want = edge_spectrum_wide(reads, RHO, "cpu")
    assert mismatched_wide(want, got) == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------ reference vs brute force
def rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def value(s: str) -> int:
    v = 0
    for ch in s:
        v = v * 4 + BASES.index(ch)
    return v


def brute_spectrum(seqs, rho):
    """Every window of rho ACGT bases and its reverse complement, counted
    as Python ints -> sorted [(value, count)]."""
    counts = Counter()
    for s in seqs:
        for i in range(len(s) - rho + 1):
            w = s[i : i + rho]
            if "N" not in w:
                counts[value(w)] += 1
                counts[value(rc(w))] += 1
    return sorted(counts.items())


@pytest.mark.parametrize("rho", [32, RHO, 62])
def test_reference_equals_the_brute_force(rho):
    rng = np.random.default_rng(rho)
    seqs = ["".join(BASES[c] for c in rng.integers(0, 4, 90)) for _ in range(300)]
    seqs = [s[:j] + "N" + s[j + 1:] if i % 7 == 0 else s
            for i, (s, j) in enumerate(zip(seqs, rng.integers(0, 90, 300)))]
    half = "".join(BASES[c] for c in rng.integers(0, 4, rho // 2))
    pal = half + rc(half) if rho % 2 == 0 else None
    if pal is not None:  # palindromes: one window equal to its own reverse complement
        seqs[:3] = [pal + s[: 90 - rho] for s in seqs[:3]]
    codes = np.array([[BASES.index(c) if c in BASES else 4 for c in s]
                      for s in seqs], np.uint8)
    hi, lo, c = edge_spectrum_wide(codes, rho, "cpu")
    n_lo = rho // 2
    got = [((h << (2 * n_lo)) | l, n) for h, l, n in zip(hi.tolist(), lo.tolist(), c.tolist())]
    want = brute_spectrum(seqs, rho)
    assert got == want
    if pal is not None:
        assert dict(want)[value(pal)] == 6  # three reads, each window twice
    # the control leaves out the reads with an N
    ctrl = edge_spectrum_wide(codes, rho, "cpu", drop_reads_with_n=True)
    assert ctrl[2].sum() < c.sum()


def test_reference_refuses_what_two_halves_cannot_hold():
    codes = np.zeros((1, 80), np.uint8)
    for rho in (31, 63):
        with pytest.raises(ValueError, match="two halves"):
            edge_spectrum_wide(codes, rho, "cpu")


# ----------------------------------------------- the entry's comparison
def broken(spec, how):
    hi, lo, c = (t.clone() for t in spec)
    if how == "dropped edge":
        return hi[1:], lo[1:], c[1:]
    if how == "changed count":
        c[5] += 1
        return hi, lo, c
    if how == "edge twice":
        return (torch.cat([hi, hi[:1]]), torch.cat([lo, lo[:1]]),
                torch.cat([c, c[:1]]))
    if how == "low half changed":
        lo[7] ^= 1
        return hi, lo, c
    if how == "out of order":
        p = torch.randperm(hi.numel(), generator=torch.Generator().manual_seed(1))
        return hi[p], lo[p], c[p]
    raise ValueError(how)


@pytest.mark.parametrize("how,want", [
    ("dropped edge", 1), ("changed count", 2), ("edge twice", 1),
    ("low half changed", 2), ("out of order", 0)])
def test_the_comparison_catches_a_broken_graph(how, want):
    _genome, reads = make_reads(np.random.default_rng(3), genome_len=3_000,
                                coverage=5, read_len=150, n_with_n=2)
    spec = edge_spectrum_wide(reads, RHO, "cpu")
    assert mismatched_wide(spec, spec) == 0
    assert mismatched_wide(spec, broken(spec, how)) == want
