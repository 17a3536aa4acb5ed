"""Sequence file parsing: FASTA / FASTQ / raw-line reads.

Replaces the reference's pull-iterator chain (``src/LineSource.cc``,
``src/FastaParser.hh``, ``src/FastqParser.hh:29-205``,
``src/ReadSequenceFileSequence.hh``, ``src/ReadPairSequenceFileSequence.hh``)
with buffered generators.  Format is sniffed from the first byte as a
fallback, or chosen from the file suffix like the reference's
``GossReadSequenceFactory`` registry.

:func:`read_batches` and :func:`read_pair_batches` give the same reads a
:class:`ReadBatch` at a time: FASTQ as one buffer of the input's bytes and
the offsets of its records, parsed a block at a time with numpy
(:func:`fastq_batches`), so that a record can be written back as its own
bytes; FASTA and line inputs through their parsers.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from itertools import islice
from typing import Iterable, Iterator

import numpy as np

from .factory import FileFactory, PhysicalFileFactory

FASTQ_BLOCK = 4 << 20  # bytes the batch FASTQ reader reads at a time


@dataclass
class Read:
    label: str
    seq: bytes
    qual: bytes | None = None


def sniff_format(first_byte: bytes) -> str:
    if first_byte == b">":
        return "fasta"
    if first_byte == b"@":
        return "fastq"
    return "line"


def format_for(name: str) -> str | None:
    base = name[:-3] if name.endswith(".gz") else name
    for suf, fmt in (
        (".fa", "fasta"),
        (".fasta", "fasta"),
        (".fna", "fasta"),
        (".fq", "fastq"),
        (".fastq", "fastq"),
        (".txt", "line"),
    ):
        if base.endswith(suf):
            return fmt
    return None


def parse_fasta(f) -> Iterator[Read]:
    label = None
    chunks: list[bytes] = []
    for raw in f:
        line = raw.rstrip(b"\r\n")
        if line.startswith(b">"):
            if label is not None:
                yield Read(label, b"".join(chunks))
            label = line[1:].decode()
            chunks = []
        elif line:
            chunks.append(line)
    if label is not None:
        yield Read(label, b"".join(chunks))


def parse_fastq(f) -> Iterator[Read]:
    while True:
        hdr = f.readline()
        if not hdr:
            return
        hdr = hdr.rstrip(b"\r\n")
        if not hdr:
            continue
        seq = f.readline().rstrip(b"\r\n")
        f.readline()  # '+'
        qual = f.readline().rstrip(b"\r\n")
        yield Read(hdr[1:].decode() if hdr.startswith(b"@") else hdr.decode(), seq, qual)


def parse_lines(f) -> Iterator[Read]:
    for i, raw in enumerate(f):
        line = raw.rstrip(b"\r\n")
        if line:
            yield Read(str(i), line)


_PARSERS = {"fasta": parse_fasta, "fastq": parse_fastq, "line": parse_lines}


def read_file(name: str, fac: FileFactory | None = None, fmt: str | None = None) -> Iterator[Read]:
    """Yield reads from one file (gzip-transparent, format-sniffed)."""
    f, fmt = _open(name, fac or PhysicalFileFactory(), fmt)
    try:
        yield from _PARSERS[fmt](f)
    finally:
        f.close()


def _open(name: str, fac: FileFactory, fmt: str | None):
    """``name`` opened for reading, and its format: ``fmt``, else the
    suffix's, else the first byte's."""
    fmt = fmt or format_for(name)
    f = fac.open_read(name)
    if fmt is None:
        try:
            first = f.peek(1)[:1] if hasattr(f, "peek") else b""
            if not first:
                data = f.read()
                first = data[:1]
                f = io.BufferedReader(io.BytesIO(data))
        except BaseException:
            f.close()
            raise
        fmt = sniff_format(first)
    return f, fmt


def read_files(names: Iterable[str], fac: FileFactory | None = None) -> Iterator[Read]:
    """Concatenate reads from many files (``ReadSequenceFileSequence``)."""
    for name in names:
        yield from read_file(name, fac)


def read_pair_files(
    lhs_names: Iterable[str], rhs_names: Iterable[str], fac: FileFactory | None = None
) -> Iterator[tuple[Read, Read]]:
    """Lockstep paired reads (``src/ReadPairSequenceFileSequence.hh:21``)."""
    lhs = read_files(lhs_names, fac)
    rhs = read_files(rhs_names, fac)
    while True:
        a = next(lhs, None)
        b = next(rhs, None)
        if a is None or b is None:
            if (a is None) != (b is None):
                raise ValueError("paired read files have unequal read counts")
            return
        yield a, b


# ------------------------------------------------------------- batches
# rows of ReadBatch.off: each record's bytes (blank lines before it left
# out), then its header, sequence and quality lines (CR/LF stripped)
START, END, HDR, HDR_END, SEQ, SEQ_END, QUAL, QUAL_END = range(8)


class ReadBatch:
    """Reads in input order.  A FASTQ batch is ``buf``, bytes of the input,
    and ``off``, int64 offsets into it (8 rows, one column a record, rows
    named above); ``canonical`` marks the records whose bytes are
    ``@label\\nseq\\n+\\nqual\\n`` in ASCII.  Other batches hold their
    :class:`Read` objects, and ``buf``, ``off`` and ``canonical`` are
    None.  ``seqs``: each read's sequence, as bytes (the encoder's
    input)."""

    __slots__ = ("buf", "off", "canonical", "seqs", "_reads")

    def __init__(self, buf: bytes | None, off: np.ndarray | None,
                 canonical: np.ndarray | None, reads: list[Read] | None = None):
        self.buf, self.off, self.canonical, self._reads = buf, off, canonical, reads
        if buf is None:
            self.seqs = [r.seq for r in reads]
        else:
            self.seqs = [buf[s:e] for s, e in zip(off[SEQ].tolist(), off[SEQ_END].tolist())]

    @classmethod
    def of_reads(cls, reads: list[Read]) -> "ReadBatch":
        return cls(None, None, None, reads)

    def __len__(self) -> int:
        return len(self.seqs)

    def read(self, i: int) -> Read:
        """The ``i``-th read, as :func:`parse_fastq` gives it."""
        if self.buf is None:
            return self._reads[i]
        _s, _e, h, he, s, se, q, qe = self.off[:, i].tolist()
        hdr, b = self.buf[h:he], self.buf
        return Read(hdr[1:].decode() if hdr.startswith(b"@") else hdr.decode(),
                    b[s:se], b[q:qe])

    def reads(self) -> list[Read]:
        if self.buf is None:
            return self._reads
        return [self.read(i) for i in range(len(self))]

    @classmethod
    def concat(cls, parts: list["ReadBatch"]) -> "ReadBatch":
        """One batch of ``parts`` in order (a batch that spans files)."""
        if len(parts) == 1:
            return parts[0]
        if any(p.buf is None for p in parts):
            return cls.of_reads([r for p in parts for r in p.reads()])
        bufs, offs, base = [], [], 0
        for p in parts:
            lo, hi = int(p.off[START, 0]), int(p.off[END, -1])
            bufs.append(p.buf[lo:hi])
            offs.append(p.off + (base - lo))
            base += hi - lo
        return cls(b"".join(bufs), np.concatenate(offs, axis=1),
                   np.concatenate([p.canonical for p in parts]))


def _header_lines(blank: np.ndarray) -> np.ndarray:
    """The index of each record's header line: records of four lines, a
    blank line skipped where a header is expected (:func:`parse_fastq`)."""
    n, p, heads = len(blank), 0, []
    for b in np.flatnonzero(blank).tolist():
        if (b - p) % 4 == 0:  # else the blank line is inside a record
            heads.append(np.arange(p, b, 4))
            p = b + 1
    heads.append(np.arange(p, n, 4))
    return np.concatenate(heads)


def _fastq_records(data: bytes, eof: bool):
    """(off, canonical, used) of the FASTQ records in ``data``: every record
    at ``eof`` (a truncated last one with empty lines), else the whole
    records alone, which end at ``used``."""
    a = np.frombuffer(data, np.uint8)
    # one pass for the line ends and the bytes a canonical record lacks
    # (CR, and any byte above 0x7F, which the int8 view makes negative)
    special = np.flatnonzero(a.view(np.int8) < 14)
    b = a[special]
    le = special[b == 10]  # line ends, the '\n' excluded
    odd = special[(b == 13) | (b > 127)]
    if eof and len(a) > (int(le[-1]) + 1 if len(le) else 0):
        le = np.append(le, len(a))  # a last line with no '\n'
    ls = np.zeros_like(le)
    ls[1:] = le[:-1] + 1
    ce = le.copy()  # line ends with trailing '\r's stripped
    cr = np.flatnonzero(ce > ls)
    while len(cr := cr[a[ce[cr] - 1] == 13]):
        ce[cr] -= 1
        cr = cr[ce[cr] > ls[cr]]
    n_lines = len(le)
    h = _header_lines(ce == ls)
    whole = h + 3 < n_lines
    if not eof:
        h, whole = h[whole], whole[whole]
    last = np.minimum(h + 3, n_lines - 1)
    off = np.empty((8, len(h)), np.int64)
    off[START], off[HDR], off[HDR_END] = ls[h], ls[h], ce[h]
    off[END] = le[last] + (le[last] < len(a))
    for row, j in ((SEQ, h + 1), (QUAL, h + 3)):
        there = j < n_lines
        j = np.minimum(j, n_lines - 1)
        off[row] = np.where(there, ls[j], off[END])
        off[row + 1] = np.where(there, ce[j], off[END])
    plus = np.minimum(h + 2, n_lines - 1)
    canonical = (whole & (a[ls[h]] == 64) & (ce[plus] - ls[plus] == 1)
                 & (a[ls[plus]] == 43) & (le[last] < len(a)))
    if len(odd) and len(h):
        r = np.searchsorted(off[START], odd, side="right") - 1
        r = r[(r >= 0) & (odd < off[END, np.maximum(r, 0)])]
        canonical[r] = False
    used = int(off[END, -1]) if len(h) else 0
    return off, canonical, used


class _FastqBlocks:
    """The records of one FASTQ stream, parsed ``block`` bytes at a time; a
    record that crosses a block's end is parsed again with the next."""

    def __init__(self, f, block: int):
        self.f, self.block = f, block
        self.data, self.eof, self.used, self.i = b"", False, 0, 0
        self.off, self.canonical = np.zeros((8, 0), np.int64), np.zeros(0, bool)

    def take(self, n: int) -> ReadBatch | None:
        """The next ``n`` records (fewer at the end; None after it)."""
        while self.off.shape[1] - self.i < n and not self.eof:
            more = self.f.read(self.block)
            self.eof = not more
            keep = (int(self.off[START, self.i]) if self.i < self.off.shape[1]
                    else self.used)
            self.data = b"".join((memoryview(self.data)[keep:], more))
            self.off, self.canonical, self.used = _fastq_records(self.data, self.eof)
            self.i = 0
        j = min(self.i + n, self.off.shape[1])
        if j == self.i:
            return None
        batch = ReadBatch(self.data, self.off[:, self.i:j], self.canonical[self.i:j])
        self.i = j
        for k in np.flatnonzero(~batch.canonical).tolist():
            batch.read(k)  # a header that is not UTF-8 raises here, as in parse_fastq
        return batch


class _ParsedReads:
    """``take`` over a per-read parser (FASTA, lines)."""

    def __init__(self, reads: Iterator[Read]):
        self.reads = reads

    def take(self, n: int) -> ReadBatch | None:
        buf = list(islice(self.reads, n))
        return ReadBatch.of_reads(buf) if buf else None


def fastq_batches(f, n: int, block: int = FASTQ_BLOCK) -> Iterator[ReadBatch]:
    """The records of FASTQ stream ``f`` in batches of ``n`` (the last one
    shorter), exactly as :func:`parse_fastq` gives them."""
    src = _FastqBlocks(f, block)
    while (batch := src.take(n)) is not None:
        yield batch


def read_batches(files: Iterable[tuple[str, str | None]], n: int,
                 fac: FileFactory | None = None,
                 block: int = FASTQ_BLOCK) -> Iterator[ReadBatch]:
    """The reads of ``files``, (name, format or None) as :func:`read_file`
    takes them, in batches of ``n`` that span files (the last one
    shorter)."""
    fac = fac or PhysicalFileFactory()
    parts, have = [], 0
    for name, fmt in files:
        f, fmt = _open(name, fac, fmt)
        try:
            src = (_FastqBlocks(f, block) if fmt == "fastq"
                   else _ParsedReads(_PARSERS[fmt](f)))
            while (batch := src.take(n - have)) is not None:
                parts.append(batch)
                have += len(batch)
                if have == n:
                    yield ReadBatch.concat(parts)
                    parts, have = [], 0
        finally:
            f.close()
    if parts:
        yield ReadBatch.concat(parts)


def read_pair_batches(lhs_names: Iterable[str], rhs_names: Iterable[str], n: int,
                      fac: FileFactory | None = None,
                      block: int = FASTQ_BLOCK) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    """:func:`read_pair_files` a batch of ``n`` pairs at a time; raises as
    it does, at the batch that holds the first unpaired read."""
    lhs = read_batches(((x, None) for x in lhs_names), n, fac, block)
    rhs = read_batches(((x, None) for x in rhs_names), n, fac, block)
    while True:
        a = next(lhs, None)
        b = next(rhs, None)
        if a is None and b is None:
            return
        if a is None or b is None or len(a) != len(b):
            raise ValueError("paired read files have unequal read counts")
        yield a, b
