"""Sequence file parsing: FASTA / FASTQ / raw-line reads.

Replaces the reference's pull-iterator chain (``src/LineSource.cc``,
``src/FastaParser.hh``, ``src/FastqParser.hh:29-205``,
``src/ReadSequenceFileSequence.hh``, ``src/ReadPairSequenceFileSequence.hh``)
with buffered generators.  Format is sniffed from the first byte as a
fallback, or chosen from the file suffix like the reference's
``GossReadSequenceFactory`` registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

from .factory import FileFactory, PhysicalFileFactory


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
    fac = fac or PhysicalFileFactory()
    fmt = fmt or format_for(name)
    f = fac.open_read(name)
    try:
        if fmt is None:
            first = f.peek(1)[:1] if hasattr(f, "peek") else b""
            if not first:
                data = f.read()
                first = data[:1]
                import io

                f = io.BufferedReader(io.BytesIO(data))
            fmt = sniff_format(first)
        yield from _PARSERS[fmt](f)
    finally:
        f.close()


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
