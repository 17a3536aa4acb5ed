"""Reads of a xenograft sample: a seeded graft and host reference of
``config["graft_length"]`` and ``config["host_length"]`` bases, sharing one
segment that the host's copy carries with substitutions, and
``config["sample_reads"]`` reads of ``config["read_length"]`` drawn
from graft, host, the shared segment and random sequence in the mix's
shares, on either strand, with substitutions and one N in every
``mix["n_every"]`` reads, in one FASTQ file.

``make_references`` and ``sample_reads`` are frozen from ``chip_smoke.py``
at commit 04cc210.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ._seqio import write_fastq, write_reference


def make_references(rng, length=4_600_000, seg_at=100_000, seg_len=20_000,
                    seg_sub=0.005):
    """Codes of a graft and a host reference (seeded, random) sharing one
    segment; the host's copy carries point substitutions, so that
    compute-near-kmers has marginal k-mers to find."""
    graft = rng.integers(0, 4, length, dtype=np.uint8)
    host = rng.integers(0, 4, length, dtype=np.uint8)
    seg = rng.integers(0, 4, seg_len, dtype=np.uint8)
    graft[seg_at : seg_at + seg_len] = seg
    pos = rng.choice(seg_len, int(seg_len * seg_sub), replace=False)
    hseg = seg.copy()
    hseg[pos] = (hseg[pos] + rng.integers(1, 4, len(pos), dtype=np.uint8)) % 4
    host[seg_at : seg_at + seg_len] = hseg
    return graft, host, seg


def sample_reads(rng, sources, weights, n, read_len=100, sub_rate=0.005,
                 n_every=1000, with_src=False):
    """uint8[n, read_len] codes (4 = N): reads of the sources (None: random
    sequence) in the given shares, either strand, with substitutions and
    one N in every ``n_every`` reads.  ``with_src``: also the index of each
    read's source."""
    src = rng.choice(len(sources), n, p=weights)
    reads = np.empty((n, read_len), np.uint8)
    for i, seq in enumerate(sources):
        rows = np.nonzero(src == i)[0]
        if seq is None:
            reads[rows] = rng.integers(0, 4, (len(rows), read_len), dtype=np.uint8)
            continue
        starts = rng.integers(0, len(seq) - read_len + 1, len(rows))
        reads[rows] = np.lib.stride_tricks.sliding_window_view(seq, read_len)[starts]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    n_sub = rng.binomial(reads.size, sub_rate)
    pos = rng.integers(0, reads.size, n_sub)
    flat = reads.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, n // n_every, replace=False)
    reads[rows, rng.integers(0, read_len, len(rows))] = 4
    return (reads, src) if with_src else reads


def make(config: dict, mix: dict, seed: int, workdir: Path) -> dict:
    rng = np.random.default_rng(seed % 2 ** 64)
    if config["graft_length"] != config["host_length"]:
        raise ValueError("the frozen generator makes references of one length")
    graft, host, seg = make_references(
        rng, length=config["graft_length"], seg_at=config["segment_at"],
        seg_len=config["segment_length"],
        seg_sub=config["segment_substitution_rate"])
    shares = mix["shares"]
    reads = sample_reads(
        rng, [graft, host, seg, None],
        [shares["graft"], shares["host"], shares["segment"], shares["random"]],
        config["sample_reads"], read_len=config["read_length"],
        sub_rate=mix["substitution_rate"], n_every=mix["n_every"])
    workdir = Path(workdir)
    paths = {name: str(workdir / f"{name}.fa") for name in ("graft", "host")}
    write_reference(paths["graft"], "graft", graft)
    write_reference(paths["host"], "host", host)
    fastq = workdir / "reads.fastq"
    write_fastq(fastq, reads)
    return {"graft": graft, "host": host, "reads": reads,
            "graft_fasta": paths["graft"], "host_fasta": paths["host"],
            "reads_fastq": str(fastq)}
