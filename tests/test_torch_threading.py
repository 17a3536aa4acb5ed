"""The port's ``thread-reads`` / ``thread-pairs`` (``algo/threading.py``),
its threading bindings and its ``BatchTask`` / ``KillSignal``.

* The reference's gold fixtures (``tests/data/ref_threading``,
  ``ref_pairs``) through the port, with the assertions of
  ``tests/test_ref_parity_{threading,pairs}.py``.
* The port against the JAX functions on N-free reads from a seeded genome
  with planted repeats: the same supergraph after ``thread_reads`` (edge
  cache rates 0 and 4) and ``thread_pairs`` (each orientation handling).
* Reads with an ``N``: the port's links equal a per-read brute force (an
  ``N`` only drops the windows over it), and differ from the JAX
  package's, which cuts such a read in two (ROADMAP C.7).  The native
  block reader with the counted read lengths gives the links of the
  parsed reads.
* ``BatchTask`` / ``KillSignal`` cases of ``tests/test_batch_task.py``.
"""

import gzip
import io
import os
import time

import numpy as np
import pytest

from gossamer_tpu.algo import threading as jthr
from gossamer_tpu.graph import entry_edge_set as jees
from gossamer_tpu.graph import graph as jgraph
from gossamer_tpu.graph import supergraph as jsg
from gossamer_tpu.io.readers import Read as JRead
from gossamer_tpu_torch.algo import threading as pthr
from gossamer_tpu_torch.algo.super_contigs import _ChainIndex, path_contig
from gossamer_tpu_torch.graph import entry_edge_set as pees
from gossamer_tpu_torch.graph import graph as pgraph
from gossamer_tpu_torch.graph import supergraph as psg
from gossamer_tpu_torch.graph.text import restore_graph
from gossamer_tpu_torch.io import native
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.utils.batch_task import (AbortRequested, BatchTask,
                                                 KillSignal)

import test_ref_parity_pairs as ref_pairs
import test_ref_parity_threading as ref_threading
from test_torch_graph import spectrum

K = 15
ACGT = np.frombuffer(b"ACGTN", np.uint8)


def unavailable():
    raise native.NativeUnavailable("made unavailable by the test")


# ------------------------------------------------------------ gold fixtures
def paths_of(sg, g):
    ci = _ChainIndex(g)
    return [(path_contig(sg, g, ci, pid)[0],
             tuple(s if psg.seg_is_gap(s) else (s & psg.SEG_MASK)
                   for s in sg.segs[pid]))
            for pid in sg.path_ids()]


def assert_gold(sg, got, expected, name):
    def loopish(segs):
        return (not any(psg.seg_is_gap(s) for s in segs)
                and ref_threading._is_loop(sg, segs))

    rot = ref_threading._min_rotation
    assert len(got) == len(expected), name
    assert (sorted(x for x in got if not loopish(x[1]))
            == sorted(e for e in expected if not loopish(e[1]))), name
    assert (sorted(rot(x[1]) for x in got if loopish(x[1]))
            == sorted(rot(e[1]) for e in expected if loopish(e[1]))), name


def fixture_graph(data, name):
    with open(os.path.join(data, name, "input.dump")) as f:
        return restore_graph(io.StringIO(f.read()))


@pytest.mark.parametrize("name", ref_threading.FIXTURES)
def test_thread_reads_gold_parity(name):
    _g, read_seqs, opts, expected = ref_threading._load(name)
    g = fixture_graph(ref_threading.DATA, name)
    sg = psg.SuperGraph.create(pees.EntryEdgeSet.build(g))
    reads = [Read(str(i), s.encode()) for i, s in enumerate(read_seqs)]
    pthr.thread_reads(sg, g, reads,
                      min_link_count=opts.get("min_link_count", 10),
                      expected_coverage=opts["expected_coverage"],
                      edge_cache_rate=0)
    assert_gold(sg, paths_of(sg, g), expected, name)


@pytest.mark.parametrize("name", ref_pairs.FIXTURES)
def test_thread_pairs_gold_parity(name):
    _g, pair_seqs, opts, expected = ref_pairs._load(name)
    g = fixture_graph(ref_pairs.DATA, name)
    sg = psg.SuperGraph.create(pees.EntryEdgeSet.build(g))
    pairs = [(Read(f"p{i}/1", l.encode()), Read(f"p{i}/2", r.encode()))
             for i, (l, r) in enumerate(pair_seqs)]
    pthr.thread_pairs(
        sg, g, pairs,
        orientation=ref_pairs.ORIENT[opts.get("orientation", "pe")],
        min_link_count=int(opts.get("min_link_count", 10)),
        insert_size=int(opts["insert_expected_size"]),
        insert_std_dev_pct=float(opts.get("insert_size_std_dev", 10.0)),
        insert_tolerance=float(opts.get("insert_size_tolerance", 2.0)),
        expected_coverage=float(opts["expected_coverage"]),
        fill_gaps=bool(int(opts.get("fill_gaps", "0"))),
        consolidate_paths=bool(int(opts.get("consolidate_paths", "0"))),
        max_gap=int(opts.get("max_gap", 1 << 60)),
        search_radius=int(opts.get("search_radius", 10)),
        edge_cache_rate=0)
    assert_gold(sg, paths_of(sg, g), expected, name)


# ----------------------------------------------------- seeded repeat genome
def genome(seed=7, unique=150, short_repeat=24, long_repeat=90):
    """Unique stretches joined by copies of a repeat longer than k and
    shorter than a read, and of one longer than a read and shorter than
    the insert."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, short_repeat, dtype=np.uint8)
    lrep = rng.integers(0, 4, long_repeat, dtype=np.uint8)
    parts = [rng.integers(0, 4, unique, dtype=np.uint8)]
    for rep in (s, lrep, s, lrep, s):
        parts += [rep, rng.integers(0, 4, unique, dtype=np.uint8)]
    return np.concatenate(parts)


def pair_codes(gen, seed=8, n=700, length=60, insert=240):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(gen) - insert, n)
    frags = np.lib.stride_tricks.sliding_window_view(gen, insert)[starts]
    lhs = frags[:, :length].copy()
    rhs = 3 - frags[:, ::-1][:, :length]
    return lhs, rhs


def as_bytes(codes):
    return ACGT[codes].tobytes()


def graphs_and_sgs(reads):
    lo, hi, c = spectrum(reads, K + 1)
    gj = jgraph.Graph(K, lo.copy(), hi.copy(), c.copy())
    gp = pgraph.Graph(K, lo.copy(), hi.copy(), c.copy())
    return (gj, jsg.SuperGraph.create(jees.EntryEdgeSet.build(gj)),
            gp, psg.SuperGraph.create(pees.EntryEdgeSet.build(gp)))


def state(sg):
    return sg.segs, sg.rcs, sg.succ, sg.next_id, sg.count


@pytest.fixture(scope="module")
def seeded():
    lhs, rhs = pair_codes(genome())
    return lhs, rhs, np.concatenate([lhs, rhs])


@pytest.mark.parametrize("rate", [0, 4])
def test_thread_reads_matches_jax(seeded, rate):
    lhs, rhs, reads = seeded
    gj, sj, gp, sp = graphs_and_sgs(reads)
    seqs = [as_bytes(r) for r in reads]
    nj = jthr.thread_reads(sj, gj, [JRead(str(i), s) for i, s in enumerate(seqs)],
                           min_link_count=3, expected_coverage=None,
                           edge_cache_rate=rate)
    np_ = pthr.thread_reads(sp, gp, [Read(str(i), s) for i, s in enumerate(seqs)],
                            min_link_count=3, expected_coverage=None,
                            edge_cache_rate=rate, num_threads=2)
    assert nj == np_ and (rate or np_ > 0)
    assert state(sj) == state(sp)


@pytest.mark.parametrize("orientation,kw", [
    ("paired-ends", {}), ("paired-ends", {"fill_gaps": True}),
    ("paired-ends", {"consolidate_paths": True, "insert_size": 240}),
    ("outies", {}), ("mate-pairs", {})])
def test_thread_pairs_matches_jax(seeded, orientation, kw):
    lhs, rhs, reads = seeded
    gj, sj, gp, sp = graphs_and_sgs(reads)
    if orientation != "paired-ends":  # the same fragments, read as such
        lhs, rhs = rhs, lhs
    pairs = [(as_bytes(a), as_bytes(b)) for a, b in zip(lhs, rhs)]
    nj = jthr.thread_pairs(sj, gj, [(JRead("a", a), JRead("b", b))
                                    for a, b in pairs],
                           orientation=orientation, min_link_count=3, **kw)
    np_ = pthr.thread_pairs(sp, gp, [(Read("a", a), Read("b", b))
                                     for a, b in pairs],
                            orientation=orientation, min_link_count=3, **kw)
    assert nj == np_
    assert state(sj) == state(sp)
    if orientation == "paired-ends" and not kw:
        assert np_ > 0


# ------------------------------------------------------ reads with an N
def brute_links(reads: list[bytes], idx, ucache, rho: int):
    """Per read, on its own: walk its windows in order, skip each window
    with an N, anchor the rest one by one (a window keeps the superpath of
    the run it continues through an out-degree-1 node), then a link per
    change of unique superpath, its gap the emitted windows between."""
    g = idx.g
    count, gaps = {}, {}
    for seq in reads:
        hits = []  # (emitted window number, superpath)
        emitted = 0
        prev = None  # (ok, out-degree 1) of the previous window
        run_pid = run_ok = None
        for i in range(len(seq) - rho + 1):
            w = seq[i : i + rho]
            if b"N" in w:
                prev = None
                continue
            emitted += 1
            v = 0
            for c in w:
                v = (v << 2) | b"ACGT".index(c)
            lo, hi = np.array([v & (2**64 - 1)], np.uint64), np.array([v >> 64], np.uint64)
            pid, _off, ok = idx.align_kmers(lo, hi)
            ok = bool(ok[0])
            tlo, thi = g.to_node(lo, hi)
            outd1 = int(np.asarray(g.out_degree(tlo, thi))[0]) == 1
            if not (prev is not None and prev[0] and ok and prev[1]):
                run_pid, run_ok = int(pid[0]), ok
            prev = (ok, outd1)
            if run_ok and run_pid >= 0 and ucache.unique(run_pid):
                hits.append((emitted, run_pid))
        events = [j for j in range(len(hits))
                  if j == 0 or hits[j][1] != hits[j - 1][1]]
        for p, c in zip(events, events[1:]):
            key = (hits[p][1], hits[c][1])
            count[key] = count.get(key, 0) + 1
            gaps[key] = gaps.get(key, 0) + (hits[c][0] - hits[p][0]) - (c - p)
    return count, gaps


@pytest.fixture(scope="module")
def with_n(seeded):
    """The seeded reads, one in four with an N in its middle third."""
    _lhs, _rhs, reads = seeded
    rng = np.random.default_rng(9)
    gj, sj, gp, sp = graphs_and_sgs(reads)
    codes = reads.copy()
    rows = np.arange(0, len(codes), 4)
    codes[rows, rng.integers(20, 40, len(rows))] = 4
    return [as_bytes(r) for r in codes], gj, sj, gp, sp


def coverage(g) -> float:
    from gossamer_tpu_torch.algo.coverage import estimate_coverage

    return float(estimate_coverage(*g.hist()))


def test_reads_with_n_link_as_one_read(with_n, tmp_path):
    from gossamer_tpu.io.native import native_read_blocks as jax_blocks

    seqs, gj, sj, gp, sp = with_n
    idx = pthr.PathIndex(gp, sp, 0)
    uc = pthr.UniquenessCache(sp, coverage(gp))
    seqs = seqs[::3]  # the brute force anchors one window at a time
    got = pthr.collect_read_links([Read(str(i), s) for i, s in enumerate(seqs)],
                                  idx, uc, gp.rho, batch=97)
    count, gaps = brute_links(seqs, idx, uc, gp.rho)
    assert dict(got.count) == count and dict(got.gap_sum) == gaps
    assert len(count) >= 4
    # the JAX package counts a read per 255 code: its parsed-read path runs
    # past its reads, its native block path cuts each read at its N
    jidx = jthr.PathIndex(gj, sj, 0)
    juc = jthr.UniquenessCache(sj, coverage(gp))
    with pytest.raises(IndexError):
        jthr.collect_read_links([JRead(str(i), s) for i, s in enumerate(seqs)],
                                jidx, juc, gj.rho, batch=97)
    write_fastq(tmp_path / "r.fastq", seqs)
    jl = jthr.collect_read_links_flat(
        jax_blocks([str(tmp_path / "r.fastq")], "fastq", 1), jidx, juc, gj.rho)
    assert dict(jl.count) != count


def write_fastq(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")


def test_native_blocks_with_read_lengths_give_the_parsed_links(with_n, tmp_path):
    seqs, _gj, _sj, gp, sp = with_n
    idx = pthr.PathIndex(gp, sp, 0)
    uc = pthr.UniquenessCache(sp, coverage(gp))
    half = len(seqs) // 2
    paths = [str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq")]
    write_fastq(paths[0], seqs[:half])
    write_fastq(paths[1], seqs[half:])
    parsed = pthr.collect_read_links(
        [Read(str(i), s) for i, s in enumerate(seqs)], idx, uc, gp.rho)
    lengths = np.concatenate([native.read_lengths(p, "fastq") for p in paths])
    assert list(lengths) == [len(s) for s in seqs]
    blocks = pthr.blocks_with_read_lengths(
        native.native_read_blocks(paths, "fastq", 1), lengths)
    flat = pthr.collect_read_links_flat(blocks, idx, uc, gp.rho, num_threads=2)
    assert dict(flat.count) == dict(parsed.count)
    assert dict(flat.gap_sum) == dict(parsed.gap_sum)
    with pytest.raises(ValueError, match="read end"):
        list(pthr.blocks_with_read_lengths(
            native.native_read_blocks(paths, "fastq", 1), lengths[:-1]))


def test_thread_reads_cli_native_reader_equals_parsed(with_n, tmp_path,
                                                      monkeypatch):
    from gossamer_tpu_torch.cli.goss import main as goss

    seqs = with_n[0]
    write_fastq(tmp_path / "r.fastq", seqs)
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{s.decode()}\n" for i, s in enumerate(seqs)))
    outs = {}
    for form in ("native", "numpy"):
        if form == "numpy":
            monkeypatch.setattr(native, "load_library", unavailable)
        g = str(tmp_path / f"g_{form}")
        for args in (["build-graph", "-k", str(K), "-I", str(fa), "-O", g,
                      "--chunk-size", "4096"],
                     ["trim-graph", "-G", g, "-O", g, "-C", "2"],
                     ["build-entry-edge-set", "-G", g],
                     ["build-supergraph", "-G", g],
                     ["thread-reads", "-G", g, "-i", str(tmp_path / "r.fastq"),
                      "--min-link-count", "3"]):
            assert goss(args + ["--device", "cpu"]) == 0, args
        outs[form] = {n.split("-", 1)[1]: (tmp_path / n).read_bytes()
                      for n in os.listdir(tmp_path)
                      if n.startswith(f"g_{form}-supergraph")}
    assert outs["native"] == outs["numpy"] and len(outs["native"]) == 5


# ----------------------------------------------------------------- bindings
@pytest.mark.parametrize("fmt", ["fasta", "fastq", "line"])
@pytest.mark.parametrize("gz", [False, True])
def test_read_lengths_follow_the_native_parser(tmp_path, fmt, gz):
    text = {"fastq": "@a\nACGN\n+\nIIII\n@b\r\nAC\r\n+\r\nII\r\n@c\n\n+\n\n@d\nGGGT",
            "fasta": "AC\n>x\nACGT\nNNA\n\n>y\n>z\nT\r\n>w\nGA",
            "line": "ACGT\n\nAAN\r\nG"}[fmt].encode()
    path = tmp_path / f"r.{fmt}{'.gz' if gz else ''}"
    path.write_bytes(gzip.compress(text) if gz else text)
    lengths = native.read_lengths(str(path), fmt)
    blocks = list(native.native_read_blocks([str(path)], fmt))
    flat = np.concatenate(blocks)
    assert len(flat) == int((lengths + 1).sum())
    np.testing.assert_array_equal(flat[np.cumsum(lengths + 1) - 1], 255)
    assert list(lengths) == {"fastq": [4, 2, 4], "fasta": [2, 7, 1, 2],
                             "line": [4, 3, 1]}[fmt]


def test_native_kmerize_equals_numpy(monkeypatch):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, 3000).astype(np.uint8)
    codes[codes == 4] = 255
    got = pthr._kmerize(codes, K + 1)
    lo, valid = native.native_kmerize_u64(codes, K + 1)
    monkeypatch.setattr(native, "load_library", unavailable)
    want = pthr._kmerize(codes, K + 1)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0][want[2]], want[0][want[2]])
    np.testing.assert_array_equal(lo, got[0])
    with pytest.raises(native.NativeUnavailable):
        native.native_kmerize_u64(codes, K + 1)
    with pytest.raises(native.NativeUnavailable):
        native.native_read_blocks(["x.fa"], "fasta")
    with pytest.raises(ValueError, match="2\\*rho"):
        native.native_kmerize_u64(codes, 33)


# --------------------------------------------------- BatchTask / KillSignal
@pytest.mark.parametrize("threads", [1, 3])
def test_batch_task_merges_all_blocks(threads):
    blocks = [np.arange(i, i + 10) for i in range(0, 200, 10)]
    seen, progress = [], []
    BatchTask(threads, on_progress=progress.append).run(
        iter(blocks), lambda b: int(b.sum()), seen.append)
    assert sorted(seen) == sorted(int(b.sum()) for b in blocks)
    assert progress[-1] == len(blocks)


@pytest.mark.parametrize("threads", [1, 3])
def test_batch_task_propagates_worker_error(threads):
    def worker(b):
        if b == 7:
            raise ValueError("boom")
        return b

    with pytest.raises(ValueError, match="boom"):
        BatchTask(threads).run(range(32), worker, lambda r: None)


def test_batch_task_streaming_source_not_materialized():
    high_water, outstanding = [0], [0]

    def source():
        for i in range(64):
            outstanding[0] += 1
            high_water[0] = max(high_water[0], outstanding[0])
            yield i

    def worker(b):
        time.sleep(0.001)
        outstanding[0] -= 1
        return b

    BatchTask(2).run(source(), worker, lambda r: None)
    assert high_water[0] <= 2 * 2 + 2


def test_kill_signal_cooperative_abort(tmp_path):
    kf = str(tmp_path / "kill")
    ks = KillSignal(kf, check_every_s=0.01, hard_exit=False).start()
    try:
        def worker(b):
            if b == 3:
                open(kf, "w").write("x")
            time.sleep(0.03)
            return b

        with pytest.raises(AbortRequested):
            BatchTask(2, kill=ks).run(range(1000), worker, lambda r: None)
    finally:
        ks.stop()


def test_kill_signal_requested_flag(tmp_path):
    kf = str(tmp_path / "kill2")
    ks = KillSignal(kf, check_every_s=0.01, hard_exit=False).start()
    assert not ks.requested()
    open(kf, "w").write("x")
    time.sleep(0.1)
    assert ks.requested()
    ks.stop()
