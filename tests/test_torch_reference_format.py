"""The reference's binary formats in the port (``io/reference_format.py``,
``io/reference_write.py``) against the JAX package's.

* The four fixtures under ``tests/data/ref_format`` (written by the
  reference's own Builders, ``scripts/baseline/make_ref_graph.cc``: a
  narrow graph, a 68-bit graph, counts over all three byte layers with
  the ``.upr``/``.lwr`` low-bit split, a k = 25 k-mer set) read into the
  port's ``Graph`` / ``KmerSet`` equal to the JAX reads.
* The port's writers give the fixtures' bytes, every file of the set.
* ``upgrade-graph`` in both formats, both CLIs: the same files.
* A header that is neither format still raises.
"""

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from gossamer_tpu.graph.graph import Graph as JGraph
from gossamer_tpu.graph.kmer_set import KmerSet as JKmerSet
from gossamer_tpu.io import reference_format as JRF
from gossamer_tpu.io.factory import PhysicalFileFactory as JFac
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io import reference_format as RF
from gossamer_tpu_torch.io.factory import PhysicalFileFactory, StringFileFactory
from gossamer_tpu_torch.io.reference_write import (write_reference_graph,
                                                   write_reference_kmer_set)

from test_torch_contigs import files, run_jax, run_port

DATA = Path(__file__).parent / "data" / "ref_format"
FAC = PhysicalFileFactory()
GRAPHS = ["graph_k11", "graph_k33", "graph_layers"]


def fixture_files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("fixture", GRAPHS)
def test_reference_graph_reads_equal_jax(fixture):
    base = str(DATA / fixture / "graph")
    g, jg = Graph.read(base, FAC), JGraph.read(base, JFac())
    assert (g.k, g.asymmetric, g.count) == (jg.k, jg.asymmetric, jg.count) > (0, 0)
    for a, b in ((g.lo, jg.lo), (g.hi, jg.hi), (g.counts, jg.counts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if fixture == "graph_layers":
        assert {300, 70000, 1 << 24} <= set(np.asarray(g.counts).tolist())
    if fixture == "graph_k33":
        assert np.asarray(g.hi).any() and (np.asarray(g.hi) <= 0xF).all()


def test_reference_kmer_set_reads_equal_jax():
    base = str(DATA / "kset_k25" / "graph")
    ks, jks = KmerSet.read(base, FAC), JKmerSet.read(base, JFac())
    assert ks.k == jks.k == 25 and ks.count == jks.count > 0
    np.testing.assert_array_equal(ks.lo, jks.lo)
    np.testing.assert_array_equal(ks.hi, jks.hi)
    assert (np.diff(ks.lo.astype(np.int64)) > 0).all()


@pytest.mark.parametrize("fixture", [*GRAPHS, "kset_k25"])
def test_sparse_and_variable_byte_arrays_equal_jax(fixture):
    base = str(DATA / fixture / "graph")
    sparse = base + (".kmers" if fixture == "kset_k25" else "-edges")
    for a, b in zip(RF.read_sparse_array(FAC, sparse),
                    JRF.read_sparse_array(JFac(), sparse)):
        np.testing.assert_array_equal(a, b)
    if fixture != "kset_k25":
        np.testing.assert_array_equal(
            RF.read_variable_byte_array(FAC, base + "-counts"),
            JRF.read_variable_byte_array(JFac(), base + "-counts"))
    assert RF.is_reference_graph(FAC, base)


@pytest.mark.parametrize("fixture", GRAPHS)
def test_graph_writer_gives_the_fixture_bytes(fixture):
    d = DATA / fixture
    base = str(d / "graph")
    _v, k, flags = struct.unpack_from("<QQQ", RF._read_bytes(FAC, base + ".header"))
    lo, hi = RF.read_sparse_array(FAC, base + "-edges")
    counts = RF.read_variable_byte_array(FAC, base + "-counts")[: len(lo)]
    out = StringFileFactory()
    write_reference_graph(out, "graph", int(k), lo, hi, counts,
                          asymmetric=bool(flags & 1))
    want = fixture_files(d)
    assert {n: out.read_file(n) for n in out.names()} == want
    assert fixture != "graph_layers" or "graph-edges.low-bits.upr" in want


def test_kmer_set_writer_gives_the_fixture_bytes():
    d = DATA / "kset_k25"
    base = str(d / "graph")
    _v, k, _n = struct.unpack_from("<QQQ", RF._read_bytes(FAC, base + ".header"))
    lo, hi = RF.read_sparse_array(FAC, base + ".kmers")
    out = StringFileFactory()
    write_reference_kmer_set(out, "graph", int(k), lo, hi)
    want = fixture_files(d)
    assert {n: out.read_file(n) for n in out.names()} == want
    assert "graph.kmers.low-bits.lwr" in want


@pytest.mark.parametrize("k", [13, 33])
def test_writer_round_trips_through_the_reader(k):
    rng = np.random.default_rng(5 + k)
    lo = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    hi = (rng.integers(0, 1 << (2 * k + 2 - 64), len(lo)).astype(np.uint64)
          if 2 * k + 2 > 64 else np.zeros_like(lo))
    if 2 * k + 2 <= 64:
        lo &= np.uint64((1 << (2 * k + 2)) - 1)
        lo = np.unique(lo)
        hi = np.zeros_like(lo)
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    counts = rng.integers(1, 1 << 20, len(lo)).astype(np.int64)
    out = StringFileFactory()
    write_reference_graph(out, "g", k, lo, hi, counts)
    g = Graph.read("g", out)
    np.testing.assert_array_equal(g.lo, lo)
    np.testing.assert_array_equal(np.asarray(g.hi), hi)
    np.testing.assert_array_equal(g.counts, counts)


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_upgrade_graph_matches_jax(tmp_path, fmt):
    """A reference-format graph upgraded by each CLI (to this package's
    format, or rewritten in the reference's): the same files, which read
    back to the same graph."""
    for stem in ("j", "p"):
        for f in (DATA / "graph_k11").iterdir():
            shutil.copy(f, tmp_path / f.name.replace("graph", stem, 1))
    before = Graph.read(str(tmp_path / "p"), FAC)
    run_jax(["upgrade-graph", "-G", str(tmp_path / "j"), "--format", fmt])
    run_port(["upgrade-graph", "-G", str(tmp_path / "p"), "--format", fmt])
    fj, fp = files(tmp_path, "j"), files(tmp_path, "p")
    assert fj == fp
    assert (".edges-lo" in fp) == (fmt == "native")
    after = Graph.read(str(tmp_path / "p"), FAC)
    np.testing.assert_array_equal(after.lo, before.lo)
    np.testing.assert_array_equal(after.counts, before.counts)
    if fmt == "reference":
        assert fp == {n[len("graph"):]: b for n, b in
                      fixture_files(DATA / "graph_k11").items()}


def test_a_header_of_neither_format_raises(tmp_path):
    (tmp_path / "x.header").write_bytes(b"\x00\x01binary")
    (tmp_path / "y.header").write_bytes(struct.pack("<QQQ", 12345, 11, 0))
    for name in ("x", "y"):
        with pytest.raises((ValueError, UnicodeDecodeError)):
            KmerSet.read(str(tmp_path / name), FAC)
        with pytest.raises((ValueError, UnicodeDecodeError)):
            Graph.read(str(tmp_path / name), FAC)
        assert not RF.is_reference_graph(FAC, str(tmp_path / name))
