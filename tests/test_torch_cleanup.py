"""The port's cleanup passes (trim-graph, prune-tips, pop-bubbles), the
coverage model and the gold fixtures of the reference, exactly.

The shapes of ``tests/test_cleanup.py`` (a low-coverage path, a short tip,
an isolated path, nested tips, a SNP bubble, an equal-time bubble, no
bubble) and a noisy read set go through the JAX functions and the port's
on the same seeded spectrum, at a narrow and a wide k.  The fixtures of
``tests/data/ref_cleanup`` (made by the reference's own compiled code) go
through the port as ``tests/test_ref_parity_cleanup.py`` runs them through
the JAX package.
"""

import io
import os

import numpy as np
import pytest

from gossamer_tpu.algo import cleanup as jclean
from gossamer_tpu.algo import coverage as jcov
from gossamer_tpu.algo import tour_bus as jbus
from gossamer_tpu_torch.algo import cleanup as pclean
from gossamer_tpu_torch.algo import coverage as pcov
from gossamer_tpu_torch.algo import tour_bus as pbus
from gossamer_tpu_torch.algo.contigs import print_contigs
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.text import restore_graph
from gossamer_tpu_torch.graph.trimmer import TrimView

from test_torch_graph import graph_pair, noisy_reads, spectrum

KS = [11, 40]


def seqs_to_reads(seqs):
    """Sequences of any lengths -> one spectrum's worth of code rows."""
    return [np.array(["ACGT".index(c) for c in s], np.uint8)[None, :]
            for s in seqs]


def pair_from_seqs(seqs, k):
    """(JAX graph, port graph) of the build-graph spectrum of ``seqs``."""
    parts = [spectrum(r, k + 1) for r in seqs_to_reads(seqs) if r.shape[1] > k]
    lo = np.concatenate([p[0] for p in parts])
    hi = np.concatenate([p[1] for p in parts])
    c = np.concatenate([p[2] for p in parts])
    order = np.lexsort((lo, hi))
    lo, hi, c = lo[order], hi[order], c[order]
    new = np.ones(len(lo), bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    counts = np.add.reduceat(c, np.nonzero(new)[0])
    return graph_pair(lo[new], hi[new], counts.astype(np.int64), k)


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def edges(g):
    return g.lo.tolist(), np.asarray(g.hi).tolist(), g.counts.tolist()


def shapes(k):
    """name -> read sequences, the shapes of tests/test_cleanup.py."""
    rng = np.random.default_rng(100 + k)
    flank = max(60, k + 20)
    main, noise = rand_seq(rng, 3 * flank), rand_seq(rng, flank)
    backbone = rand_seq(rng, 5 * flank)
    tip = backbone[2 * flank - k - 9 : 2 * flank] + rand_seq(rng, 8)
    s1, s2 = rand_seq(rng, flank), rand_seq(rng, flank)
    major, minor = s1 + "A" + s2, s1 + "C" + s2
    outer = backbone[2 * flank : 2 * flank + k + 9] + rand_seq(rng, 30)
    inner = outer[20 : 20 + k + 9] + rand_seq(rng, 6)
    return {
        "low coverage": [main] * 5 + [noise],
        "short tip": [backbone] * 4 + [tip] * 2,
        "isolated path": [rand_seq(rng, flank)],
        "nested tips": [backbone] * 6 + [outer] * 2 + [inner] * 2,
        "snp bubble": [major] * 5 + [minor] * 2,
        "equal-time bubble": [major] * 3 + [minor] * 3,
        "no bubble": [rand_seq(rng, 2 * flank)] * 3,
    }


SHAPES = list(shapes(11))


# ---------------------------------------------------------------- the passes
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cleanup_shapes_match_jax(shape, k):
    gj, gp = pair_from_seqs(shapes(k)[shape], k)
    assert edges(jclean.trim_graph(gj, 3)) == edges(pclean.trim_graph(gp, 3))
    for it in (1, 5):
        assert edges(jclean.prune_tips(gj, iterations=it)) == \
            edges(pclean.prune_tips(gp, iterations=it))
    bj, nj = jbus.pop_bubbles(gj)
    bp, np_ = pbus.pop_bubbles(gp)
    assert nj == np_ and edges(bj) == edges(bp)
    assert bp.lint() == []
    # what each shape is there for
    view = TrimView(gp)
    tips, zapped = pclean.prune_tips_once(view)
    if shape == "low coverage":
        assert pclean.trim_graph(gp, 3).count < gp.count
    if shape in ("short tip", "nested tips"):
        assert tips >= 1 and zapped >= 2 and view.finalize().lint() == []
    if shape == "isolated path":
        assert (tips, zapped) == (0, 0)
    if shape in ("snp bubble", "equal-time bubble"):
        assert np_ >= 1 and bp.count < gp.count
    if shape == "no bubble":
        assert np_ == 0 and bp.count == gp.count


@pytest.mark.parametrize("k", [15, 40])
@pytest.mark.parametrize("kw", [
    {"iterations": 1}, {"iterations": 4}, {"iterations": 4, "cutoff": 2},
    {"iterations": 1, "relative_cutoff": 0.1},
    {"iterations": 4, "cutoff": 3, "relative_cutoff": 0.5}])
def test_prune_tips_on_noisy_reads_matches_jax(k, kw):
    gj, gp = graph_pair(*spectrum(noisy_reads(21), k + 1), k)
    logs = []
    got = pclean.prune_tips(gp, log=lambda sev, msg: logs.append(msg), **kw)
    want = jclean.prune_tips(gj, **kw)
    assert edges(got) == edges(want)
    assert got.lint() == [] and logs and logs[0].startswith("prune-tips pass 1")
    if kw == {"iterations": 4}:
        assert got.count < gp.count


def test_prune_tips_compacts_once():
    gj, gp = graph_pair(*spectrum(noisy_reads(21), 16), 15)
    calls = []
    orig = gp.remove_edges
    gp.remove_edges = lambda dead: calls.append(int(dead.sum())) or orig(dead)
    pclean.prune_tips(gp, iterations=5)
    assert len(calls) == 1


@pytest.mark.parametrize("k", [15, 40])
@pytest.mark.parametrize("kw", [
    {}, {"cutoff": 2}, {"relative_cutoff": 0.9},
    {"max_sequence_length": 40, "max_edit_distance": 1},
    {"max_relative_error": 0.001}])
def test_pop_bubbles_on_noisy_reads_matches_jax(k, kw):
    gj, gp = graph_pair(*spectrum(noisy_reads(22, sub_rate=0.006), k + 1), k)
    (bj, nj), (bp, np_) = jbus.pop_bubbles(gj, **kw), pbus.pop_bubbles(gp, **kw)
    assert nj == np_ and edges(bj) == edges(bp)
    assert bp.lint() == []
    if not kw and k == 15:  # 80 bp reads close no bubble of 41-mers
        assert np_ >= 1


def test_pop_bubbles_of_empty_graph():
    z = np.zeros(0, np.uint64)
    _gj, gp = graph_pair(z, z, np.zeros(0, np.int64), 15)
    g2, n = pbus.pop_bubbles(gp)
    assert n == 0 and g2.count == 0
    assert pclean.prune_tips(gp, iterations=3).count == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_edit_distance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 30, dtype=np.uint8)
    b = np.delete(a, [3, 17])
    b[10] = (b[10] + 1) % 4
    assert pbus.edit_distance(a, b) == jbus.edit_distance(a, b) == 3
    assert pbus.edit_distance(a, a[:0]) == len(a)


# ---------------------------------------------------------- coverage model
def coverage_hist(seed, mean=30.0, errors=0.3):
    """Multiplicity histogram of a simulated library: an error spike and a
    coverage peak."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([rng.poisson(mean, 200_000),
                             1 + rng.poisson(errors, 120_000)])
    return np.unique(counts[counts > 0], return_counts=True)


@pytest.mark.parametrize("seed,mean", [(1, 30.0), (2, 55.0), (3, 12.0)])
def test_coverage_model_matches_jax(seed, mean):
    mult, freq = coverage_hist(seed, mean)
    mj, mp = jcov.fit_coverage_model(mult, freq), pcov.fit_coverage_model(mult, freq)
    assert (mj is None) == (mp is None)
    if mp is not None:
        assert (mj.mix, mj.lam, mj.mean, mj.std, mj.chi_sq, mj.dof) == \
            (mp.mix, mp.lam, mp.mean, mp.std, mp.chi_sq, mp.dof)
        assert mj.fits() == mp.fits() and mj.trim_point() == mp.trim_point()
    cut = pcov.estimate_trim_cutoff(mult, freq)
    assert cut == jcov.estimate_trim_cutoff(mult, freq) and 2 <= cut < mean
    assert pcov.estimate_coverage(mult, freq) == jcov.estimate_coverage(mult, freq)


@pytest.mark.parametrize("mult,freq", [
    ([1, 2, 3], [50, 9, 1]), ([], []), ([1], [7]),
    (list(range(1, 41)), [900, 300, 90, 30, 10, 12, 18, 27, 40, 56, 70, 80, 85,
                          82, 75, 64, 50, 38, 27, 18, 12, 8, 5, 3, 2, 1, 1, 1,
                          1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1])])
def test_trim_cutoff_valley_form_matches_jax(mult, freq):
    """Too few multiplicities for the fit: the histogram valley decides."""
    mult, freq = np.array(mult, np.int64), np.array(freq, np.int64)
    assert pcov.fit_coverage_model(mult, freq) is None
    assert pcov.estimate_trim_cutoff(mult, freq) == \
        jcov.estimate_trim_cutoff(mult, freq)
    assert pcov.estimate_coverage(mult, freq) == jcov.estimate_coverage(mult, freq)


# ------------------------------------------------------------ gold fixtures
DATA = os.path.join(os.path.dirname(__file__), "data", "ref_cleanup")
FIXTURES = sorted(os.listdir(DATA))


def load(name):
    with open(os.path.join(DATA, name, "input.dump")) as f:
        g = restore_graph(f)
    with open(os.path.join(DATA, name, "expected.dump")) as f:
        expected = f.read()
    with open(os.path.join(DATA, name, "args.txt")) as f:
        args = f.read().split()

    def arg(flag, kind):
        return kind(args[args.index(flag) + 1]) if flag in args else None

    return g, expected, arg


def dump_edges(g):
    if g.count == 0:
        return ""
    mat = K.kmers_to_strings(g.rho, g.lo, g.hi)
    return "".join(row.tobytes().decode() + "\t" + str(int(c)) + "\n"
                   for row, c in zip(mat, g.counts))


@pytest.mark.parametrize("name", [f for f in FIXTURES
                                  if "pop" in f or "bubble" in f])
def test_pop_bubbles_matches_reference(name):
    g, expected, arg = load(name)
    kw = {"cutoff": arg("--cutoff", int),
          "relative_cutoff": arg("--relative-cutoff", float)}
    g2, _ = pbus.pop_bubbles(g, **{k: v for k, v in kw.items() if v is not None})
    assert dump_edges(g2) == expected


@pytest.mark.parametrize("name", [f for f in FIXTURES
                                  if "prune" in f or "tip" in f])
def test_prune_tips_matches_reference(name):
    g, expected, arg = load(name)
    kw = {"cutoff": arg("--cutoff", int),
          "relative_cutoff": arg("--relative-cutoff", float)}
    g = pclean.prune_tips(g, iterations=arg("--iterate", int) or 1,
                          **{k: v for k, v in kw.items() if v is not None})
    assert dump_edges(g) == expected


@pytest.mark.parametrize("name", [f for f in FIXTURES if "contig" in f])
def test_print_contigs_matches_reference(name):
    g, expected, arg = load(name)
    kw = {"min_length": arg("--min-length", int),
          "min_coverage": arg("--min-coverage", int)}
    out = io.StringIO()
    print_contigs(g, out, verbose_headers=True,
                  **{k: v for k, v in kw.items() if v is not None})
    assert out.getvalue() == expected
