"""Read pairs of a paired-end xenograft library: the seeded graft and host
references of :mod:`.xenograft_reads` (``make_references``), and
``config["sample_pairs"]`` fragments drawn from graft, host, the shared
segment and random sequence in the mix's shares.  A fragment's length is
normal (``mix["fragment_mean"]``, ``mix["fragment_sd"]``), rounded and
clipped to ``config["read_length"]`` up to its source's length; it lies on
either strand; mate 1 is its first ``read_length`` bases and mate 2 the
reverse complement of its last.  A ``mix["discordant"]`` share of the pairs
takes mate 2 from a second fragment of another source, drawn from the
other three in their shares, so that the two mates of such a pair fall in
different classes.  Each file then gets the mix's substitutions and one N
in every ``mix["n_every"]`` reads.  Two FASTQ files, labels ``r<7 digits>``
the same in both.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ._seqio import write_fastq, write_reference
from .xenograft_reads import make_references

SOURCES = ("graft", "host", "segment", "random")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """The other strand of each row of base codes 0-3."""
    return 3 - codes[:, ::-1]


def fragment_ends(rng, sources, src, read_len, mean, sd):
    """(first ``read_len`` bases, last ``read_len`` bases) of one fragment a
    row, from ``sources[src[i]]`` (None: random sequence), forward strand."""
    n = len(src)
    first = np.empty((n, read_len), np.uint8)
    last = np.empty((n, read_len), np.uint8)
    lengths = np.rint(rng.normal(mean, sd, n)).astype(np.int64)
    for i, seq in enumerate(sources):
        rows = np.flatnonzero(src == i)
        if len(rows) == 0:
            continue
        if seq is None:
            flen = np.maximum(lengths[rows], read_len)
            seq = rng.integers(0, 4, int(flen.sum()), dtype=np.uint8)
            starts = np.concatenate([[0], np.cumsum(flen)[:-1]]).astype(np.int64)
        else:
            flen = np.clip(lengths[rows], read_len, len(seq))
            starts = rng.integers(0, len(seq) - flen + 1)
        win = np.lib.stride_tricks.sliding_window_view(seq, read_len)
        first[rows] = win[starts]
        last[rows] = win[starts + flen - read_len]
    return first, last


def mates(rng, first: np.ndarray, last: np.ndarray):
    """(mate 1, mate 2) of fragments with these forward-strand ends, each
    fragment on either strand: on the reverse one its first bases are the
    reverse complement of ``last``, and mate 2 is ``first`` itself."""
    flip = (rng.random(len(first)) < 0.5)[:, None]
    last_rc = reverse_complement(last)
    return np.where(flip, last_rc, first), np.where(flip, first, last_rc)


def mutate(rng, reads: np.ndarray, sub_rate: float, n_every: int) -> None:
    """Substitutions at ``sub_rate`` a base, and one N in every ``n_every``
    reads, in place (as ``xenograft_reads.sample_reads`` does)."""
    n, read_len = reads.shape
    n_sub = rng.binomial(reads.size, sub_rate)
    pos = rng.integers(0, reads.size, n_sub)
    flat = reads.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    rows = rng.choice(n, n // n_every, replace=False)
    reads[rows, rng.integers(0, read_len, len(rows))] = 4


def sample_pairs(rng, sources, weights, n, read_len, mix):
    """(mate 1 codes uint8[n, read_len], mate 2 codes, int8[n, 2] the
    source index of each mate)."""
    weights = np.asarray(weights, np.float64)
    src1 = rng.choice(len(sources), n, p=weights)
    src2 = src1.copy()
    discordant = rng.random(n) < mix["discordant"]
    for s in range(len(sources)):
        rows = np.flatnonzero(discordant & (src1 == s))
        others = weights.copy()
        others[s] = 0.0
        src2[rows] = rng.choice(len(sources), len(rows), p=others / others.sum())
    mean, sd = mix["fragment_mean"], mix["fragment_sd"]
    mates_1, mates_2 = mates(rng, *fragment_ends(rng, sources, src1, read_len,
                                                 mean, sd))
    # a discordant mate 2 comes from a fragment of its own, on its own strand
    rows = np.flatnonzero(discordant)
    _, mates_2[rows] = mates(rng, *fragment_ends(rng, sources, src2[rows],
                                                 read_len, mean, sd))
    for reads in (mates_1, mates_2):
        mutate(rng, reads, mix["substitution_rate"], mix["n_every"])
    return mates_1, mates_2, np.stack([src1, src2], 1).astype(np.int8)


def make(config: dict, mix: dict, seed: int, workdir: Path) -> dict:
    rng = np.random.default_rng(seed % 2 ** 64)
    if config["graft_length"] != config["host_length"]:
        raise ValueError("the frozen generator makes references of one length")
    graft, host, seg = make_references(
        rng, length=config["graft_length"], seg_at=config["segment_at"],
        seg_len=config["segment_length"],
        seg_sub=config["segment_substitution_rate"])
    shares = mix["shares"]
    reads_1, reads_2, sources = sample_pairs(
        rng, [graft, host, seg, None], [shares[s] for s in SOURCES],
        config["sample_pairs"], config["read_length"], mix)
    workdir = Path(workdir)
    out = {"graft": graft, "host": host, "reads_1": reads_1,
           "reads_2": reads_2, "sources": sources}
    for name, codes in (("graft", graft), ("host", host)):
        out[f"{name}_fasta"] = str(workdir / f"{name}.fa")
        write_reference(out[f"{name}_fasta"], name, codes)
    for half, reads in (("1", reads_1), ("2", reads_2)):
        out[f"reads_{half}_fastq"] = str(workdir / f"reads_{half}.fastq")
        write_fastq(out[f"reads_{half}_fastq"], reads)
    return out
