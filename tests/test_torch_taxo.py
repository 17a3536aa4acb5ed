"""The rank join (``join_ranks_batch`` / ``join_ranks_device``) and the
taxonomy commands of the port against the JAX package, exactly.

On N-free reads the port's join equals the JAX function
(``tests/test_device_classify.py``); on reads with N it equals a per-read
brute force, where the JAX function gives the windows after an ``N`` to
the next read.  ``annotate-kmers`` and ``classify-reads`` write the same
files and print the same report as the JAX CLI at k = 15 (the device
join) and k = 40 (the host join).
"""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossamer_tpu.classify import device as jdev
from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu.cmds import taxo as jtaxo
from gossamer_tpu_torch.classify import device as pdev
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.cmds import more as pmore
from gossamer_tpu_torch.cmds import taxo as ptaxo
from gossamer_tpu_torch.convert import set_from_u64
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.factory import StringFileFactory

K15 = 15
CPU = torch.device("cpu")


def kmer_set_of(genome: np.ndarray, k: int) -> KmerSet:
    """Sorted distinct normalized k-mers of an N-free code array."""
    n_win = len(genome) - k + 1
    lo = np.zeros(n_win, np.uint64)
    hi = np.zeros(n_win, np.uint64)
    for j in range(k):
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | genome[j : j + n_win].astype(np.uint64)
    nlo, nhi, _ = K.normalize(lo, hi, k)
    order = np.lexsort((nlo, nhi))
    nlo, nhi = nlo[order], nhi[order]
    new = np.ones(n_win, bool)
    new[1:] = (nlo[1:] != nlo[:-1]) | (nhi[1:] != nhi[:-1])
    return KmerSet(k, nlo[new], nhi[new])


def brute_force(reads, ref: KmerSet):
    """(read id, rank) of every matched window, each read on its own."""
    k = ref.k
    out = []
    for i, c in enumerate(reads):
        for p in range(len(c) - k + 1):
            win = c[p : p + k]
            if (win >= 4).any():
                continue
            v = 0
            for b in win:
                v = (v << 2) | int(b)
            nlo, nhi, _f = K.normalize(np.array([v & (2**64 - 1)], np.uint64),
                                       np.array([v >> 64], np.uint64), k)
            hit, r = ref.access_and_rank(nlo, nhi)
            if hit[0]:
                out.append((i, int(r[0])))
    return sorted(out)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    ref = kmer_set_of(genome, K15)
    reads = [genome[s : s + 70].copy() for s in rng.integers(0, 3930, 100)]
    flip = reads[7]
    reads[7] = (3 - flip[::-1]).copy()
    reads.append(rng.integers(0, 4, 70, dtype=np.uint8))
    reads.append(np.array([1, 2, 3], np.uint8))  # shorter than k
    return ref, reads


def pairs(rid, rank):
    return sorted(zip(rid.tolist(), rank.tolist()))


# -------------------------------------------------------------- the rank join
@pytest.mark.parametrize("window", [1 << 12, 1 << 13])
def test_join_ranks_device_matches_jax_on_n_free_reads(case, window):
    ref, reads = case
    want = pairs(*jdev.join_ranks_device(reads, jnp.asarray(ref.lo), K15,
                                         window=window))
    rid, rank = pdev.join_ranks_device(reads, set_from_u64(ref.lo, CPU), K15,
                                       window=window)
    assert pairs(rid, rank) == want and len(want) > 5000
    assert rid.dtype == np.int64 and (np.diff(rid) >= 0).all()
    if window == 1 << 12:
        assert pairs(rid, rank) == brute_force(reads, ref)


def test_join_ranks_device_on_reads_with_n_equals_brute_force(case):
    """An ``N`` is invalid but does not start a read: the windows after it
    stay with their read, and the reads after it keep their ids."""
    ref, reads = case
    rng = np.random.default_rng(24)
    reads = [r.copy() for r in reads[:40]]
    for i in (0, 3, 3, 17, 39):
        reads[i][rng.integers(0, len(reads[i]))] = 255
    reads.insert(5, np.full(30, 255, np.uint8))  # all N
    want = brute_force(reads, ref)
    for window in (None, 1 << 11):
        rid, rank = pdev.join_ranks_device(reads, set_from_u64(ref.lo, CPU),
                                           K15, window=window)
        assert pairs(rid, rank) == want
    assert 5 not in set(rid.tolist()) and {0, 3, 4, 6, 40} <= set(rid.tolist())
    # the JAX function counts every 255 as a read end and so moves the ids
    jrid, jrank = jdev.join_ranks_device(reads, jnp.asarray(ref.lo), K15,
                                         window=1 << 12)
    assert pairs(jrid, jrank) != want
    assert sorted(jrank.tolist()) == sorted(rank.tolist())


def test_join_ranks_batch_ranks_and_edges(case):
    ref, reads = case
    set_keys = set_from_u64(ref.lo, CPU)
    flat, starts = pdev._flat_batch(reads[:20], K15, 1 << 11)
    r = pdev.join_ranks_batch(torch.from_numpy(flat), set_keys, K15)
    assert r.dtype == torch.int64 and r.shape == (1 << 11,)
    rid = np.searchsorted(starts, np.arange(1 << 11), side="right") - 1
    got_pairs = sorted((int(rid[w]), int(r[w])) for w in np.nonzero(r.numpy() >= 0)[0])
    assert got_pairs == brute_force(reads[:20], ref)
    # the all-A window is key 0, below every set key or equal to the first
    zeros = torch.zeros(40, dtype=torch.uint8)
    r0 = pdev.join_ranks_batch(zeros, set_keys, K15)
    hit, rank0 = ref.access_and_rank(*K.normalize(np.zeros(1, np.uint64),
                                                  np.zeros(1, np.uint64), K15)[:2])
    assert (r0 == (int(rank0[0]) if hit[0] else -1)).all()
    # an empty set matches nothing; so does a batch of separators
    none = pdev.join_ranks_batch(torch.from_numpy(flat), set_keys[:0], K15)
    assert (none == -1).all() and none.shape == (1 << 11,)
    seps = torch.full((100,), 255, dtype=torch.uint8)
    assert (pdev.join_ranks_batch(seps, set_keys, K15) == -1).all()


def test_join_ranks_device_raises_on_a_read_longer_than_the_window(case):
    ref, _reads = case
    long_read = np.zeros(5000, np.uint8)
    with pytest.raises(ValueError, match="batch exceeds window"):
        pdev.join_ranks_device([long_read], set_from_u64(ref.lo, CPU), K15,
                               window=1 << 12)
    rid, rank = pdev.join_ranks_device([], set_from_u64(ref.lo, CPU), K15)
    assert rid.shape == rank.shape == (0,)


def test_set_plane_conversion_keeps_the_keys(case):
    ref, _reads = case
    t = set_from_u64(ref.lo, CPU)
    assert t.dtype == torch.int64 and (t[1:] > t[:-1]).all()
    np.testing.assert_array_equal(t.numpy().view(np.uint64), ref.lo)
    with pytest.raises(ValueError, match="2\\^63"):
        set_from_u64(np.array([1 << 63], np.uint64), CPU)


# ----------------------------------------------------------------- Phylogeny
TAXO = ("1\t1\troot\troot\n2\t1\tgenus\tG\n3\t2\tspecies\tS1\n"
        "4\t2\tspecies\tS2\n5\t1\tgenus\tH\n6\t5\tspecies\tS3\n\n")


@pytest.mark.parametrize("nodes,want", [
    ({3}, 3), ({3, 4}, 2), ({3, 6}, 1), ({3, 4, 6}, 1), ({2, 3}, 2), ({5, 6}, 5)])
def test_phylogeny_matches_jax(nodes, want):
    fac = StringFileFactory()
    fac.add_file("t.taxo", TAXO)
    from gossamer_tpu.io.factory import StringFileFactory as JFac

    jfac = JFac()
    jfac.add_file("t.taxo", TAXO)
    pj, pp = jtaxo.Phylogeny.read("t.taxo", jfac), ptaxo.Phylogeny.read("t.taxo", fac)
    assert (pp.parent, pp.kind, pp.name, dict(pp.kids), pp.root) == \
        (pj.parent, pj.kind, pj.name, dict(pj.kids), pj.root)
    assert pp.lca(set(nodes)) == pj.lca(set(nodes)) == want
    assert [pp.depth(n) for n in sorted(nodes)] == \
        [pj.depth(n) for n in sorted(nodes)]


def test_windows_take_read_ids_from_read_starts():
    codes = [np.array([0, 1, 255, 2, 3, 0], np.uint8), np.zeros(0, np.uint8),
             np.array([3, 3, 3], np.uint8)]
    # the helpers live in cmds/more.py, as in the JAX package; taxo.py
    # imports them from there
    assert ptaxo._windows is pmore._windows
    assert ptaxo._read_batches is pmore._read_batches
    lo, hi, valid, rid, pos = pmore._windows(codes, 2)
    assert rid.tolist() == [0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 2][: len(lo)]
    assert pos.tolist() == [0, 1, 2, 3, 4, 5, 6, 0, 0, 1, 2]
    assert valid.tolist() == [True, False, False, True, True, False, False,
                              False, True, True, False]
    assert lo[valid].tolist() == [1, 11, 12, 15, 15] and not hi.any()
    assert [len(x) for x in pmore._windows([], 2)] == [0, 0, 0, 0, 0]
    assert [len(b) for b in pmore._read_batches(range(10), 4)] == [4, 4, 2]


# ------------------------------------------------------------------- the CLI
def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def rc(s):
    return "".join("TGCA"["ACGT".index(c)] for c in reversed(s))


@pytest.mark.parametrize("k", [15, 40])
def test_taxonomy_cli_matches_jax(tmp_path, k):
    rng = np.random.default_rng(65)
    shared = rand_seq(rng, 120)
    sp = [rand_seq(rng, 300) + shared, shared + rand_seq(rng, 300),
          rand_seq(rng, 400)]
    for i, s in enumerate(sp):
        (tmp_path / f"sp{i}.fa").write_text(f">s{i}\n{s}\n")
    (tmp_path / "all.fa").write_text(
        "".join(f">s{i}\n{s}\n" for i, s in enumerate(sp)))
    (tmp_path / "taxo.tsv").write_text(TAXO)
    (tmp_path / "annots.tsv").write_text(
        "".join(f"{tmp_path}/sp{i}.fa\t{node}\n"
                for i, node in enumerate((3, 4, 6))) + "\n")
    reads = [sp[0][50:130], rc(sp[1][200:290]), sp[2][10:100],
             sp[0][310:400], rc(shared[5:100]), rand_seq(rng, 90),
             sp[0][250:340], sp[2][300:330], "ACGT"]
    (tmp_path / "r.fa").write_text(
        "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))

    out = {}
    for name, run, extra in (("j", lambda a: jax_app().main(a), []),
                             ("p", port_main, ["--device", "cpu"])):
        ks = str(tmp_path / f"ks_{name}")
        assert run(["build-kmer-set", "-k", str(k), "-I", str(tmp_path / "all.fa"),
                    "-O", ks, "--chunk-size", "4096", *extra]) == 0
        assert run(["annotate-kmers", "-G", ks, "--annot-list",
                    str(tmp_path / "annots.tsv"), "--taxonomy",
                    str(tmp_path / "taxo.tsv"), *extra]) == 0
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert run(["classify-reads", "-G", ks, "-I", str(tmp_path / "r.fa"),
                        *extra]) == 0
        out[name] = (buf.getvalue(), (tmp_path / f"ks_{name}.annotation").read_bytes(),
                     (tmp_path / f"ks_{name}.taxo").read_bytes(),
                     (tmp_path / f"ks_{name}.kmers-lo").read_bytes())
    assert out["j"] == out["p"]
    report = out["p"][0].splitlines()
    # one read each on S1 and S2, three on their shared segment or across
    # it (genus G), two on S3 (one of them 30 bp: no window at k = 40), one
    # random and one of 4 bp
    s3 = 2 if k == 15 else 1
    assert report == ["1\tspecies\tS1", "1\tspecies\tS2", "5\tgenus\tG",
                      f"{s3}\tspecies\tS3", f"{s3}\tgenus\tH",
                      f"{5 + s3}\troot\troot",
                      f"{4 - s3}\tunclassified\tunclassified"]
    annot = np.frombuffer(out["p"][1][-4 * 10:], np.uint32)
    assert set(annot.tolist()) <= {2, 3, 4, 6}


def test_classify_reads_with_n_keeps_each_read_apart(tmp_path):
    """A read with an ``N`` keeps the windows after it, and the next read
    gets none of them (the JAX CLI moves them on)."""
    rng = np.random.default_rng(66)
    a, b = rand_seq(rng, 300), rand_seq(rng, 300)
    (tmp_path / "a.fa").write_text(f">a\n{a}\n")
    (tmp_path / "b.fa").write_text(f">b\n{b}\n")
    (tmp_path / "all.fa").write_text(f">a\n{a}\n>b\n{b}\n")
    (tmp_path / "taxo.tsv").write_text(TAXO)
    (tmp_path / "annots.tsv").write_text(
        f"{tmp_path}/a.fa\t3\n{tmp_path}/b.fa\t6\n")
    # read 0: species S1 after an early N; read 1: random, matches nothing
    reads = [a[40:50] + "N" + a[51:120], rand_seq(rng, 80), b[10:90]]
    (tmp_path / "r.fa").write_text(
        "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    ks = str(tmp_path / "ks")
    for args in (["build-kmer-set", "-k", "15", "-I", str(tmp_path / "all.fa"),
                  "-O", ks, "--chunk-size", "4096"],
                 ["annotate-kmers", "-G", ks, "--annot-list",
                  str(tmp_path / "annots.tsv"), "--taxonomy",
                  str(tmp_path / "taxo.tsv")]):
        assert port_main(args + ["--device", "cpu"]) == 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port_main(["classify-reads", "-G", ks, "-I", str(tmp_path / "r.fa"),
                          "--device", "cpu"]) == 0
    assert buf.getvalue().splitlines() == [
        "1\tspecies\tS1", "1\tgenus\tG", "1\tspecies\tS3", "1\tgenus\tH",
        "2\troot\troot", "1\tunclassified\tunclassified"]
