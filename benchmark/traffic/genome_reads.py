"""Reads of one seeded random genome, as a sequencer gives them for one
assembly: ``config["genome_length"]`` bases, ``config["coverage"]``-fold
reads of ``config["read_length"]`` on either strand with the mix's
``substitution_rate`` and ``reads_with_n`` reads holding one N, in one
FASTQ file.

``make_reads`` is frozen from ``chip_smoke.py`` at commit 04cc210.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ._seqio import write_fastq


def make_reads(rng, genome_len=4_600_000, coverage=30, read_len=100,
               sub_rate=0.005, n_with_n=200):
    """A seeded genome and read set -> (genome codes uint8[genome_len], read
    codes (0-3, 4 = N) uint8[n_reads, read_len])."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    n_sub = rng.binomial(reads.size, sub_rate)
    pos = rng.integers(0, reads.size, n_sub)
    flat = reads.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, n_with_n, replace=False)
    reads[rows, rng.integers(0, read_len, n_with_n)] = 4
    return genome, reads


def make(config: dict, mix: dict, seed: int, workdir: Path) -> dict:
    rng = np.random.default_rng(seed % 2 ** 64)
    _genome, reads = make_reads(
        rng, genome_len=config["genome_length"], coverage=config["coverage"],
        read_len=config["read_length"], sub_rate=mix["substitution_rate"],
        n_with_n=mix["reads_with_n"])
    fastq = Path(workdir) / "reads.fastq"
    write_fastq(fastq, reads)
    return {"reads": reads, "reads_fastq": str(fastq)}
