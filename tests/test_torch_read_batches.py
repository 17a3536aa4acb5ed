"""The batch reader and the class files' batch writer of ``xenome
classify`` against the per-read path: ``fastq_batches`` /
``read_batches`` / ``read_pair_batches`` (``io/readers.py``) give the
reads ``parse_fastq`` / ``read_file`` / ``read_pair_files`` give, record
for record; ``write_batch`` (``classify/xenome.py``) writes the bytes
``print_read`` writes; and the CLI's class files, single-end and
``--pairs``, over FASTQ and FASTA, equal those of ``classify_reads`` /
``classify_pairs`` with ``print_read``.  No JAX."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from gossamer_tpu_torch.classify import xenome as TX
from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
from gossamer_tpu_torch.cli import xenome as cli
from gossamer_tpu_torch.io.factory import PhysicalFileFactory, StringFileFactory
from gossamer_tpu_torch.io.readers import (
    END,
    FASTQ_BLOCK,
    START,
    fastq_batches,
    parse_fastq,
    read_batches,
    read_file,
    read_pair_batches,
    read_pair_files,
)
from gossamer_tpu_torch.utils import profile

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
CLASSES = ("neither", "both", "ambiguous", "graft", "host")


def fastq(rng, n, odd=0.0):
    """``n`` FASTQ records; a share ``odd`` of them not canonical, and as
    many with a blank line before them."""
    out = []
    for i in range(n):
        seq = ACGT[rng.integers(0, 4, int(rng.integers(20, 60)))].tobytes()
        hdr, plus, eol = b"@r%d" % i, b"+", b"\n"
        if rng.random() < odd:
            kind = int(rng.integers(0, 3))
            hdr = hdr[1:] if kind == 0 else hdr
            plus = b"+r%d" % i if kind == 1 else plus
            eol = b"\r\n" if kind == 2 else eol
        if rng.random() < odd:
            out.append(b"\n")
        out.append(hdr + eol + seq + eol + plus + eol + b"I" * len(seq) + eol)
    return b"".join(out)


CASES = {
    "canonical": b"@r0\nACGT\n+\nIIII\n@r1\nGG\n+\nII\n",
    "blank lines": b"\n@r0\nACGT\n+\nIIII\n\n\r\n\n@r1\nGG\n+\nII\n\n",
    "crlf": b"@r0\r\nACGT\r\n+\r\nIIII\r\n@r1\r\nGG\r\n+\r\nII\r\n",
    "plus label": b"@r0\nACGT\n+r0\nIIII\n@r1\nG\n+\nI\n",
    "no at": b"r0\nACGT\n+\nIIII\n@r1\nA\n+\nI\n",
    "truncated": b"@r0\nACGT\n+\nIIII\n@r1\nAC",
    "truncated after header": b"@r0\nACGT\n+\nIIII\n@r1\n",
    "no last newline": b"@r0\nACGT\n+\nIIII",
    "blank inside": b"@r0\n\n+\n\n@r1\nA\n+\nI\n",
    "empty": b"",
    "many": fastq(np.random.default_rng(3), 300, odd=0.2),
}
SIZES = [(4096, FASTQ_BLOCK), (2, 5), (1, 1), (3, 64)]


def as_tuples(reads):
    return [(r.label, r.seq, r.qual) for r in reads]


@pytest.mark.parametrize("n, block", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_fastq_batches_give_what_parse_fastq_gives(case, n, block):
    """Every case of the reader, also with blocks so small that records
    cross them, and batches of n but the last."""
    data = CASES[case]
    want = as_tuples(parse_fastq(io.BytesIO(data)))
    batches = list(fastq_batches(io.BytesIO(data), n, block))
    assert [len(b) for b in batches[:-1]] == [n] * (len(batches) - 1)
    assert all(0 < len(b) <= n for b in batches)
    assert as_tuples(r for b in batches for r in b.reads()) == want
    assert [s for b in batches for s in b.seqs] == [w[1] for w in want]


@pytest.mark.parametrize("case", list(CASES))
def test_a_canonical_record_is_what_print_read_writes(case):
    for b in fastq_batches(io.BytesIO(CASES[case]), 7, 64):
        for i, rd in enumerate(b.reads()):
            text = io.StringIO()
            TX.print_read(text, rd)
            record = b.buf[b.off[START, i]:b.off[END, i]]
            assert bool(b.canonical[i]) == (record == text.getvalue().encode())
    if case == "canonical":
        assert b.canonical.all()


def test_fewer_records_than_a_batch():
    (batch,) = fastq_batches(io.BytesIO(CASES["canonical"]), 4096)
    assert len(batch) == 2 and batch.canonical.all()
    assert list(fastq_batches(io.BytesIO(b""), 4096)) == []


def test_a_label_that_is_not_utf8_raises_as_parse_fastq_does():
    data = b"@r0\nA\n+\nI\n@\xff\nA\n+\nI\n"
    with pytest.raises(UnicodeDecodeError):
        list(parse_fastq(io.BytesIO(data)))
    with pytest.raises(UnicodeDecodeError):
        list(fastq_batches(io.BytesIO(data), 4))


def test_read_batches_span_files_of_every_format_and_gzip():
    """FASTQ (plain and .gz through the factory), FASTA and a file named
    for no format (sniffed), in batches that span them."""
    fac = StringFileFactory()
    fq = fastq(np.random.default_rng(4), 11, odd=0.3)
    fac.add_file("a.fq", fq)
    fac.add_file("b.fq.gz", gzip.compress(CASES["crlf"]))
    fac.add_file("c.fa", b">x\nACG\nTT\n>y\n\n>z\nA\n")
    fac.add_file("d", CASES["blank lines"])
    files = [("a.fq", None), ("b.fq.gz", None), ("c.fa", None), ("d", None),
             ("a.fq", "fastq")]
    want = as_tuples(r for name, fmt in files for r in read_file(name, fac, fmt))
    for n in (1, 4, 5, 4096):
        batches = list(read_batches(files, n, fac, block=16))
        assert [len(b) for b in batches[:-1]] == [n] * (len(batches) - 1)
        assert as_tuples(r for b in batches for r in b.reads()) == want
        assert [s for b in batches for s in b.seqs] == [w[1] for w in want]


def test_read_pair_batches_are_read_pair_files_and_raise_as_it_does():
    fac = StringFileFactory()
    rng = np.random.default_rng(5)
    fac.add_file("l.fq", fastq(rng, 9, odd=0.3))
    fac.add_file("r.fq", fastq(rng, 9))
    fac.add_file("short.fq", fastq(rng, 5))
    want = [(as_tuples([a]), as_tuples([b]))
            for a, b in read_pair_files(["l.fq"], ["r.fq"], fac)]
    got = [(as_tuples([a]), as_tuples([b]))
           for la, lb in read_pair_batches(["l.fq"], ["r.fq"], 4, fac)
           for a, b in zip(la.reads(), lb.reads())]
    assert got == want
    # the batch that holds the first unpaired read raises, none after it
    for lhs, rhs in ((["l.fq"], ["short.fq"]), (["short.fq"], ["l.fq"])):
        seen = []
        with pytest.raises(ValueError, match="unequal read counts"):
            for a, _b in read_pair_batches(lhs, rhs, 2, fac):
                seen.append(len(a))
        assert seen == [2, 2]
        with pytest.raises(ValueError, match="unequal read counts"):
            list(read_pair_files(lhs, rhs, fac))


@pytest.mark.parametrize("odd", [0.0, 0.3, 1.0])
def test_write_batch_writes_what_print_read_writes(odd):
    """A batch of canonical records and others, to five files in the
    order of a class a record: each file's bytes as print_read's, the
    counters split by the way each record went."""
    data = fastq(np.random.default_rng(6), 200, odd=odd)
    (batch,) = fastq_batches(io.BytesIO(data), 4096, 256)
    which = np.random.default_rng(7).integers(0, 5, len(batch)).astype(np.uint8)
    want = [io.BytesIO() for _ in range(5)]
    text = [io.TextIOWrapper(w, write_through=True) for w in want]
    for rd, k in zip(batch.reads(), which.tolist()):
        TX.print_read(text[k], rd)
    got = [io.BytesIO() for _ in range(5)]
    profile.reset()
    profile.enable()
    try:
        TX.write_batch(got, batch, which)
    finally:
        profile.enable(False)
    assert [g.getvalue() for g in got] == [w.getvalue() for w in want]
    raw = int(batch.canonical.sum())
    assert profile.totals()["#write_raw"] == raw
    assert profile.totals()["#write_formatted"] == len(batch) - raw
    assert (raw == len(batch)) == (odd == 0.0) and (raw == 0) == (odd == 1.0)
    profile.reset()


def test_write_batch_of_fasta_reads_formats_each():
    fac = StringFileFactory()
    fac.add_file("c.fa", b">x\nACG\nTT\n>y\n\n>z\nA\n")
    (batch,) = read_batches([("c.fa", None)], 10, fac)
    got = [io.BytesIO(), io.BytesIO()]
    TX.write_batch(got, batch, np.array([1, 0, 1], np.uint8))
    assert [g.getvalue() for g in got] == [b">y\n\n", b">x\nACGTT\n>z\nA\n"]


# ------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """An index at k 13, reads as FASTQ (canonical and not, in two files)
    and FASTA, and mate files of each."""
    tmp = tmp_path_factory.mktemp("read_batches")
    rng = np.random.default_rng(24)
    shared = rng.integers(0, 4, 150)
    graft = np.concatenate([rng.integers(0, 4, 2000), shared])
    host = graft.copy()
    host[:2000] = rng.integers(0, 4, 2000)
    host[::97] = (host[::97] + 1) % 4
    (tmp / "graft.fa").write_text(f">g\n{ACGT[graft].tobytes().decode()}\n")
    (tmp / "host.fa").write_text(f">h\n{ACGT[host].tobytes().decode()}\n")
    seqs = []
    for i in range(240):
        src = (graft, host, shared, rng.integers(0, 4, 120))[i % 4]
        length = int(rng.integers(40, 80))
        p = int(rng.integers(0, len(src) - length))
        seqs.append(ACGT[src[p:p + length]].tobytes().decode())

    def records(part, fmt, odd):
        out = []
        for i, s in enumerate(part):
            if fmt == "fasta":
                out.append(f">r{i} x\n{s[:30]}\n{s[30:]}\n")
            elif i % 5 == 4 and odd:  # not canonical: CRLF, a labelled '+'
                out.append(f"@r{i}\r\n{s}\r\n+r{i}\n{'I' * len(s)}\n")
            else:
                out.append(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
        return "".join(out)

    for fmt, ext in (("fastq", "fq"), ("fasta", "fa")):
        (tmp / f"a.{ext}").write_text(records(seqs[:150], fmt, True))
        (tmp / f"b.{ext}").write_text(records(seqs[150:], fmt, False))
        (tmp / f"r1.{ext}").write_text(records(seqs[0::2], fmt, True))
        (tmp / f"r2.{ext}").write_text(records(seqs[1::2], fmt, False))
    assert cli.main(["index", "-K", "13", "-G", str(tmp / "graft.fa"), "-H",
                     str(tmp / "host.fa"), "-P", str(tmp / "idx"),
                     "--device", "cpu"]) == 0
    return tmp


def per_read_files(tmp, pairs: bool, ext: str) -> dict[str, bytes]:
    """The class files of the per-read path: classify_reads or
    classify_pairs, then print_read a read into its class's text file."""
    fac = PhysicalFileFactory()
    ann = AnnotatedKmerSet.read(str(tmp / "idx"), fac)
    halves = ("1", "2") if pairs else ("",)
    text = {(c, h): io.TextIOWrapper(io.BytesIO(), write_through=True)
            for c in CLASSES for h in halves}
    name = {"lhs": "graft", "rhs": "host"}
    if pairs:
        for a, b, x in TX.classify_pairs(read_pair_files(
                [str(tmp / f"r1.{ext}")], [str(tmp / f"r2.{ext}")], fac),
                ann, device=CPU, batch_reads=7):
            c = name.get(TX.OUT_CLASS[x], TX.OUT_CLASS[x])
            TX.print_read(text[(c, "1")], a)
            TX.print_read(text[(c, "2")], b)
    else:
        reads = (r for f in ("a", "b") for r in read_file(str(tmp / f"{f}.{ext}"), fac))
        for rd, x in TX.classify_reads(reads, ann, device=CPU, batch_reads=7):
            c = name.get(TX.OUT_CLASS[x], TX.OUT_CLASS[x])
            TX.print_read(text[(c, "")], rd)
    return {f"{c}{'_' + h if h else ''}": t.buffer.getvalue()
            for (c, h), t in text.items()}


@pytest.mark.parametrize("ext", ["fq", "fa"])
@pytest.mark.parametrize("pairs", [False, True], ids=["single", "pairs"])
def test_classify_files_are_the_per_read_paths(world, pairs, ext, monkeypatch):
    """Batches of 7 reads, so that single-end batches span the two input
    files; every class file equal to the per-read path's, some records of
    each FASTQ class file not canonical."""
    tmp = world
    monkeypatch.setattr(cli, "BATCH_READS", 7)
    opt = "-i" if ext == "fq" else "-I"
    inputs = ([opt, str(tmp / f"r1.{ext}"), opt, str(tmp / f"r2.{ext}"), "--pairs"]
              if pairs else [opt, str(tmp / f"a.{ext}"), opt, str(tmp / f"b.{ext}")])
    out = tmp / f"out-{ext}-{pairs}"
    with contextlib.redirect_stdout(io.StringIO()) as stats:
        assert cli.main(["classify", "-P", str(tmp / "idx"),
                         "--output-filename-prefix", str(out), "--device", "cpu",
                         *inputs]) == 0
    suffix = "fastq" if ext == "fq" else "fasta"
    want = per_read_files(tmp, pairs, ext)
    got = {k: (tmp / f"{out.name}_{k}.{suffix}").read_bytes() for k in want}
    assert got == want
    assert sum(len(v) for v in got.values()) > 0
    assert "Summary" in stats.getvalue()
    if ext == "fq":
        assert sum(v.count(b"\r\n") for v in got.values()) == 0


def test_classify_pairs_of_unequal_counts_raises(world, tmp_path, capsys):
    """The error of the per-read path, at the batch that holds the first
    unpaired read: none of that batch written."""
    tmp = world
    lines = (tmp / "r2.fq").read_text().splitlines(keepends=True)
    (tmp_path / "short.fq").write_text("".join(lines[:-4]))  # a read short
    rc = cli.main(["classify", "-P", str(tmp / "idx"), "--pairs", "--device", "cpu",
                   "--output-filename-prefix", str(tmp_path / "o"),
                   "-i", str(tmp / "r1.fq"), "-i", str(tmp_path / "short.fq")])
    assert rc == 1
    assert "paired read files have unequal read counts" in capsys.readouterr().err
    assert sum((tmp_path / f"o_{c}_1.fastq").read_bytes().count(b"\n")
               for c in CLASSES) == 0
