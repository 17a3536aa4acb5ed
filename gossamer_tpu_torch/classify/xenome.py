"""Xenome-style read classification (``gossamer_tpu/classify/xenome.py``).

Engine parity with ``src/GossCmdGroupReads.cc``: per-read k-mer lookup in
an annotated union set, 2-bit class per k-mer (``c = lhs<<1 | rhs``,
``GossCmdGroupReads.cc:384-401``), OR-accumulated into a 4-bit one-hot
``blrg``; 16-way class table and output file naming as in
``GossCmdGroupReads.cc:489-577``; summary tables as in ``printStats``
(``:810-850``).  Each read is classified on its own and windows holding a
non-ACGT base are skipped (``GossCmdGroupReads.cc:381-468``).

Batches of reads go through :class:`DeviceClassifier`, which holds each
set slice on the torch device once, or, given a mesh (``n_devices`` above
1), shards each slice of narrow keys over it
(:class:`..parallel.classify_sharded.ShardedClassifier`, as
``gossamer_tpu/classify/xenome.py`` does; wide keys stay on the one
device).  :func:`_batch_blrg` is the host version, kept as the tests'
oracle.
"""

from __future__ import annotations

import io
from itertools import islice
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core import kmer as K
from ..io.readers import END, START, Read, ReadBatch
from ..utils import profile
from .annotated_set import AnnotatedKmerSet

SEP = np.uint8(255)
BATCH_READS = 4096  # reads a batch: parsed, encoded, joined, written

# blrg -> output stream class (GossCmdGroupReads.cc:606-621)
OUT_CLASS = [
    "neither", "both", "rhs", "rhs", "lhs", "lhs", "ambiguous", "ambiguous",
    "both", "both", "rhs", "rhs", "lhs", "lhs", "ambiguous", "ambiguous",
]


def class_str(lhs_name: str, rhs_name: str, i: int) -> str:
    """``classStr`` (``GossCmdGroupReads.cc:489-527``)."""
    table = {
        0x0: "neither",
        0x1: "both",
        0x2: "definitely " + rhs_name,
        0x3: "probably " + rhs_name,
        0x4: "definitely " + lhs_name,
        0x5: "probably " + lhs_name,
        0x6: "ambiguous",
        0x7: "ambiguous",
        0x8: "both",
        0x9: "probably both",
        0xA: "definitely " + rhs_name,
        0xB: "probably " + rhs_name,
        0xC: "definitely " + lhs_name,
        0xD: "probably " + lhs_name,
        0xE: "ambiguous",
        0xF: "ambiguous",
    }
    return table[i]


def _batch_blrg(codes_list: list[np.ndarray], ann: AnnotatedKmerSet) -> np.ndarray:
    """blrg per read for a batch of encoded reads, on the host."""
    k = ann.kset.k
    n_reads = len(codes_list)
    blrg = np.zeros(n_reads, dtype=np.uint8)
    if n_reads == 0:
        return blrg
    # flat stream with separators; read id per position from the read
    # lengths (an invalid base inside a read is not a read boundary)
    parts = []
    for c in codes_list:
        parts.append(c)
        parts.append(np.array([SEP], dtype=np.uint8))
    flat = np.concatenate(parts)
    if len(flat) < k:
        return blrg
    read_id = np.repeat(np.arange(n_reads), [len(c) + 1 for c in codes_list])
    n_win = len(flat) - k + 1
    win_read = read_id[:n_win]

    lo = np.zeros(n_win, dtype=np.uint64)
    hi = np.zeros(n_win, dtype=np.uint64)
    valid = np.ones(n_win, dtype=bool)
    for j in range(k):
        b = flat[j : j + n_win]
        valid &= b < 4
        b64 = b.astype(np.uint64) & np.uint64(3)
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | b64
    if not valid.any():
        return blrg
    lo = lo[valid]
    hi = hi[valid]
    win_read = win_read[valid]
    nlo, nhi, _ = K.normalize(lo, hi, k)
    hit, r = ann.kset.access_and_rank(nlo, nhi)
    if not hit.any():
        return blrg
    r = r[hit]
    win_read = win_read[hit]
    c = (ann.lhs[r].astype(np.uint8) << 1) | ann.rhs[r].astype(np.uint8)
    bits = (np.uint8(1) << c).astype(np.uint8)
    np.bitwise_or.at(blrg, win_read, bits)
    return blrg


def ann_slices(ann: AnnotatedKmerSet, passes: int) -> list[AnnotatedKmerSet]:
    """Split the annotated set into rank subranges for multi-pass
    classification (``KmerClassifier`` bounds, ``GossCmdGroupReads.cc:
    416-429``).  The union over slices reproduces single-pass results."""
    if passes <= 1:
        return [ann]
    from ..graph.kmer_set import KmerSet

    z = ann.kset.count
    out = []
    for p in range(passes):
        a = p * z // passes
        b = (p + 1) * z // passes
        out.append(AnnotatedKmerSet(
            KmerSet(ann.kset.k, ann.kset.lo[a:b], ann.kset.hi[a:b]),
            ann.lhs[a:b], ann.rhs[a:b]))
    return out


class DeviceClassifier:
    """The slices of an annotated set, each held on ``device`` once as its
    sorted E tensor (:func:`.device.encode_set`; k <= 30) or, for wider
    keys, as its two E lanes (:func:`.device.encode_set_wide`; k = 31
    already goes this way, 2k + 2 = 64 bits).  With a ``mesh`` each slice
    of narrow keys is a :class:`..parallel.classify_sharded.
    ShardedClassifier` over it instead.  :meth:`blrg` ORs the slices'
    results."""

    def __init__(self, slices: list[AnnotatedKmerSet], device: torch.device,
                 mesh=None):
        from ..convert import set_from_u64, wide_set_from_u64
        from .device import encode_set, encode_set_wide

        self.k = k = slices[0].kset.k
        self.wide = 2 * k + 2 > 62
        self.sharded = mesh is not None and not self.wide
        if self.sharded:
            from ..parallel.classify_sharded import ShardedClassifier

            self.sets = [ShardedClassifier(mesh, encode_set(
                s.kset.lo, s.lhs, s.rhs), k) for s in slices]
        elif self.wide:
            self.sets = [wide_set_from_u64(*encode_set_wide(
                s.kset.lo, s.kset.hi, s.lhs, s.rhs, k), device) for s in slices]
        else:
            self.sets = [set_from_u64(encode_set(s.kset.lo, s.lhs, s.rhs), device)
                         for s in slices]

    def blrg(self, codes_list: list[np.ndarray]) -> np.ndarray:
        from .device import classify_codes_device, classify_codes_device_wide

        if self.sharded:
            results = (s.classify_codes(codes_list) for s in self.sets)
        else:
            classify = (classify_codes_device_wide if self.wide
                        else classify_codes_device)
            results = (classify(codes_list, s, self.k) for s in self.sets)
        out = next(results)
        for r in results:
            out = out | r
        return out


def _classifier(ann: AnnotatedKmerSet, passes: int, device, n_devices: int,
                mesh) -> DeviceClassifier:
    """``n_devices`` above 1 without a ``mesh`` shards narrow keys over
    :func:`..parallel.mesh.data_mesh` on ``device``, which raises when the
    cards are short (wide keys have no sharded form and stay on
    ``device``, as in the JAX package)."""
    if mesh is None and n_devices > 1:
        from ..parallel.mesh import data_mesh

        mesh = data_mesh(n_devices, device)
    with profile.context("classify/index"):  # E encoded, copied to the card
        return DeviceClassifier(ann_slices(ann, passes), device, mesh)


def classify_reads(reads: Iterable[Read], ann: AnnotatedKmerSet, *,
                   batch_reads: int = BATCH_READS,
                   **kw) -> Iterator[tuple[Read, int]]:
    """Yield (read, blrg) preserving input order, ``batch_reads`` reads a
    batch (the other keywords of :func:`classify_read_batches`)."""
    batches = (ReadBatch.of_reads(buf) for buf in _lists(reads, batch_reads))
    for batch, blrg in classify_read_batches(batches, ann, **kw):
        yield from zip(batch.reads(), blrg.tolist())


def _lists(items, n: int):
    """``items`` in lists of ``n``, the last one shorter."""
    it = iter(items)
    return iter(lambda: list(islice(it, max(1, n))), [])


def classify_read_batches(
    batches: Iterable[ReadBatch], ann: AnnotatedKmerSet, *,
    device: torch.device, passes: int = 1, n_devices: int = 1, mesh=None,
) -> Iterator[tuple[ReadBatch, np.ndarray]]:
    """Yield (batch, its reads' blrg as uint8) for each batch, in input
    order.  ``n_devices`` above 1, or a ``mesh``, shards the set of narrow
    keys over a mesh: the multipass decomposition run in space instead of
    time."""
    clf = _classifier(ann, passes, device, n_devices, mesh)
    for batch in _read_batches(batches):
        yield batch, clf.blrg(_encode(batch.seqs))


def _read_batches(batches):
    """``batches`` with each one's parse timed as one scope
    ``classify/read``: a clock reading a read would cost more than a tenth
    of the call."""
    it = iter(batches)
    while True:
        with profile.context("classify/read"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def _encode(seqs) -> list[np.ndarray]:
    with profile.context("classify/encode"):
        return [K.encode_bases(s) for s in seqs]


def classify_pairs(pairs: Iterable[tuple[Read, Read]], ann: AnnotatedKmerSet,
                   *, batch_reads: int = BATCH_READS,
                   **kw) -> Iterator[tuple[Read, Read, int]]:
    """Paired classification: blrg = OR of the mates' blrgs, ``batch_reads``
    pairs a batch (the other keywords of :func:`classify_read_batches`)."""
    batches = ((ReadBatch.of_reads([a for a, _ in buf]),
                ReadBatch.of_reads([b for _, b in buf]))
               for buf in _lists(pairs, batch_reads))
    for (lhs, rhs), blrg in classify_pair_batches(batches, ann, **kw):
        yield from zip(lhs.reads(), rhs.reads(), blrg.tolist())


def classify_pair_batches(
    batches: Iterable[tuple[ReadBatch, ReadBatch]], ann: AnnotatedKmerSet, *,
    device: torch.device, passes: int = 1, n_devices: int = 1, mesh=None,
) -> Iterator[tuple[tuple[ReadBatch, ReadBatch], np.ndarray]]:
    """:func:`classify_read_batches` of batches of mates, mate 1's and mate
    2's of the same pairs: a pair's blrg is the OR of its mates', under the
    scope ``classify/mates``; each join takes both mates, interleaved.
    While profiling is on the counters ``#pairs`` and ``#pairs_split``
    (pairs whose mates' own blrg differ: the pair rule decided their class)
    add up each batch."""
    clf = _classifier(ann, passes, device, n_devices, mesh)
    for lhs, rhs in _read_batches(batches):
        blrg = clf.blrg(_encode(s for pr in zip(lhs.seqs, rhs.seqs) for s in pr))
        with profile.context("classify/mates"):
            mate1, mate2 = blrg[0::2], blrg[1::2]
            if profile.enabled():
                profile.count("pairs", len(lhs))
                profile.count("pairs_split", int(np.count_nonzero(mate1 != mate2)))
            pair = mate1 | mate2
        yield (lhs, rhs), pair


# -------------------------------------------------------------- reporting
def print_read(out, rd: Read) -> None:
    """Round-trip a read in its original format."""
    if rd.qual is not None:
        out.write(f"@{rd.label}\n{rd.seq.decode()}\n+\n{rd.qual.decode()}\n")
    else:
        out.write(f">{rd.label}\n{rd.seq.decode()}\n")


def write_batch(outs: list, batch: ReadBatch, which: np.ndarray) -> None:
    """Each record of ``batch`` to the binary file ``outs[which[i]]``, in
    input order within each file, one write a file: a canonical record
    (:class:`..io.readers.ReadBatch`: its bytes are what :func:`print_read`
    writes) as a slice of the batch's buffer, a run of them that lie
    together in it as one slice; any other record as :func:`print_read`
    formats it.  While profiling is on the counters ``#write_raw`` and
    ``#write_formatted`` count the records written each way."""
    if profile.enabled():
        raw = 0 if batch.buf is None else int(np.count_nonzero(batch.canonical))
        profile.count("write_raw", raw)
        profile.count("write_formatted", len(batch) - raw)
    for k, out in enumerate(outs):
        idx = np.flatnonzero(which == k)
        if not len(idx):
            continue
        if batch.buf is None:
            out.write(b"".join([_formatted(batch.read(i)) for i in idx.tolist()]))
            continue
        s, e, ok = batch.off[START, idx], batch.off[END, idx], batch.canonical[idx]
        # a run goes on while the next record is canonical too and starts
        # where this one ends
        runs = np.flatnonzero(np.concatenate(
            ([True], ~(ok[1:] & ok[:-1] & (s[1:] == e[:-1])))))
        lasts = np.append(runs[1:], len(idx)) - 1
        mv = memoryview(batch.buf)
        pieces = [mv[a:b] for a, b in zip(s[runs].tolist(), e[lasts].tolist())]
        for j in np.flatnonzero(~ok[runs]).tolist():  # a run of one record
            pieces[j] = _formatted(batch.read(int(idx[runs[j]])))
        out.write(b"".join(pieces))


_TEXT_ENCODING = io.TextIOWrapper(io.BytesIO()).encoding  # what print_read's files use


def _formatted(rd: Read) -> bytes:
    text = io.StringIO()
    print_read(text, rd)
    return text.getvalue().encode(_TEXT_ENCODING)


def fmt6(x: float) -> str:
    """C++ default ostream double formatting."""
    return f"{x:.6g}"


def print_stats(out, counts, lhs_name: str, rhs_name: str, scores_only: bool) -> None:
    """``printStats`` (``GossCmdGroupReads.cc:810-850``)."""
    total = int(np.sum(counts)) or 1
    graft_c = counts[0x4] + counts[0x5] + counts[0xC] + counts[0xD]
    host_c = counts[0x2] + counts[0x3] + counts[0xA] + counts[0xB]
    both_c = counts[0x1] + counts[0x8] + counts[0x9]
    neither_c = counts[0x0]
    ambig_c = counts[0x6] + counts[0x7] + counts[0xE] + counts[0xF]
    if scores_only:
        out.write(
            "\t".join(
                fmt6(100.0 * c / total)
                for c in (graft_c, host_c, both_c, neither_c, ambig_c)
            )
            + "\n"
        )
        return
    out.write("Statistics\n")
    out.write("B\tG\tH\tM\tcount\tpercent\tclass\n")
    for i in range(16):
        out.write(
            f"{(i >> 3) & 1}\t{(i >> 2) & 1}\t{(i >> 1) & 1}\t{i & 1}\t"
            f"{int(counts[i])}\t{fmt6(100.0 * counts[i] / total)}\t"
            f'"{class_str(lhs_name, rhs_name, i)}"\n'
        )
    out.write("\nSummary\n")
    out.write("count\tpercent\tclass\n")
    for c, name in (
        (graft_c, lhs_name),
        (host_c, rhs_name),
        (both_c, "both"),
        (ambig_c, "ambiguous"),
        (neither_c, "neither"),
    ):
        out.write(f"{int(c)}\t{fmt6(100.0 * c / total)}\t{name}\n")


def out_filename(prefix: str, suffix: str, half: str, cls: str) -> str:
    """``filename`` (``GossCmdGroupReads.cc:530-547``)."""
    parts = ""
    if prefix:
        parts += prefix + "_"
    parts += cls
    if half:
        parts += "_" + half
    if suffix:
        parts += "." + suffix
    return parts
