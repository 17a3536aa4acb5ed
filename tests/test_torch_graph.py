"""The port's ``Graph`` queries, ``TrimView``, segment decomposition and
graph text format against the JAX package's, exactly.

The same seeded spectrum (a numpy count of both orientations of noisy
reads, so the graph has tips, bubbles and branch nodes) is held by a
``Graph`` of each package, at k = 15 (narrow, native fused queries) and
k = 40 (wide, the numpy/u128 forms).  The narrow cases run once with the
native library and once with it made unavailable, which must take the
numpy forms and give the same answers.
"""

import functools
import io

import numpy as np
import pytest

from gossamer_tpu.graph import graph as jgraph
from gossamer_tpu.graph import segments as jseg
from gossamer_tpu.graph import text as jtext
from gossamer_tpu.graph import trimmer as jtrim
from gossamer_tpu_torch.graph import graph as pgraph
from gossamer_tpu_torch.graph import segments as pseg
from gossamer_tpu_torch.graph import text as ptext
from gossamer_tpu_torch.graph import trimmer as ptrim
from gossamer_tpu_torch.io import native

U64 = np.uint64
KS = {"narrow": 15, "wide": 40}


# ------------------------------------------------------------ seeded inputs
def window_keys(codes: np.ndarray, k: int):
    """k-windows of the last axis as (lo, hi) uint64 keys."""
    n_win = codes.shape[-1] - k + 1
    lo = np.zeros(codes.shape[:-1] + (n_win,), U64)
    hi = np.zeros_like(lo)
    for j in range(k):
        b = codes[..., j : j + n_win].astype(U64)
        hi = (hi << U64(2)) | (lo >> U64(62))
        lo = (lo << U64(2)) | b
    return lo.reshape(-1), hi.reshape(-1)


def spectrum(reads: np.ndarray, rho: int):
    """Both orientations of every window, counted: sorted (lo, hi, counts)."""
    parts = [window_keys(seq, rho) for seq in (reads, 3 - reads[:, ::-1])]
    lo = np.concatenate([p[0] for p in parts])
    hi = np.concatenate([p[1] for p in parts])
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    new = np.ones(len(lo), bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    first = np.nonzero(new)[0]
    return lo[new], hi[new], np.diff(np.append(first, len(lo))).astype(np.int64)


def noisy_reads(seed: int, genome_len=600, n=90, length=80, sub_rate=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - length, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, length)[starts].copy()
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < sub_rate
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
    return reads


def graph_pair(lo, hi, counts, k):
    """The same arrays as a Graph of each package (JAX, port)."""
    return (jgraph.Graph(k, lo.copy(), hi.copy(), counts.copy()),
            pgraph.Graph(k, lo.copy(), hi.copy(), counts.copy()))


@functools.cache
def graphs(kind: str, seed: int = 11):
    k = KS[kind]
    return graph_pair(*spectrum(noisy_reads(seed), k + 1), k)


def same(a, b) -> None:
    """Exact equality of arrays or tuples of arrays, dtype included."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(params=["native", "numpy"])
def form(request, monkeypatch):
    """Run with the native library, then with it unavailable."""
    if request.param == "numpy":
        def unavailable():
            raise native.NativeUnavailable("made unavailable by the test")

        monkeypatch.setattr(native, "load_library", unavailable)
    return request.param


def some_nodes(g, rng, n=400):
    """Nodes of the graph (from- and to-nodes of edges) and random ones."""
    r = rng.integers(0, g.count, n)
    flo, fhi = g.from_node(g.lo[r], g.hi[r])
    tlo, thi = g.to_node(g.lo[r], g.hi[r])
    xlo, xhi = g.to_node(rng.integers(0, 1 << 62, 50).astype(U64),
                         rng.integers(0, 1 << 62, 50).astype(U64))
    return (np.concatenate([flo, tlo, xlo]), np.concatenate([fhi, thi, xhi]))


# ------------------------------------------------------------ Graph methods
NODE_METHODS = ["node_rc", "begin_end_rank", "out_degree", "in_degree",
                "node_degrees", "canonical_node"]
EDGE_METHODS = ["from_node", "to_node", "edge_rc", "rank", "access_and_rank"]


@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("method", NODE_METHODS)
def test_node_methods_match_jax(kind, method):
    gj, gp = graphs(kind)
    assert gp.hi.any() == (kind == "wide")
    nlo, nhi = some_nodes(gj, np.random.default_rng(1))
    same(getattr(gj, method)(nlo, nhi), getattr(gp, method)(nlo, nhi))


@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("method", EDGE_METHODS)
def test_edge_methods_match_jax(kind, method):
    gj, gp = graphs(kind)
    rng = np.random.default_rng(2)
    r = rng.integers(0, gj.count, 300)
    # edges of the graph, and neighbours that are mostly absent
    qlo = np.concatenate([gj.lo[r], gj.lo[r] ^ U64(1)])
    qhi = np.concatenate([gj.hi[r], gj.hi[r]])
    same(getattr(gj, method)(qlo, qhi), getattr(gp, method)(qlo, qhi))
    if method == "access_and_rank":
        hit, rank = gp.access_and_rank(qlo, qhi)
        assert hit[:300].all() and (rank[:300] == r).all() and not hit.all()


@pytest.mark.parametrize("kind", list(KS))
def test_select_multiplicity_strings_remove(kind):
    gj, gp = graphs(kind)
    rng = np.random.default_rng(3)
    r = rng.integers(0, gj.count, 200)
    same(gj.select(r), gp.select(r))
    same(gj.multiplicity(r), gp.multiplicity(r))
    same(gj.edge_strings(r), gp.edge_strings(r))
    same(gj.edge_rc_rank(), gp.edge_rc_rank())
    dead = rng.random(gj.count) < 0.3
    dj, dp = gj.remove_edges(dead), gp.remove_edges(dead)
    same((dj.lo, np.asarray(dj.hi), dj.counts), (dp.lo, np.asarray(dp.hi), dp.counts))
    assert dp.k == gp.k and dp.count == int((~dead).sum())
    assert dp.lint() == dj.lint()


def test_access_and_rank_of_empty_graph():
    z = np.zeros(0, U64)
    gj, gp = graph_pair(z, z, np.zeros(0, np.int64), 15)
    q = np.array([5, 9], U64)
    same(gj.access_and_rank(q, q * U64(0)), gp.access_and_rank(q, q * U64(0)))
    assert pseg.decompose(gp).order.size == 0


def test_begin_end_rank_wraps_at_rho_32():
    """k = 31: node << 2 fills 64 bits, and +4 wraps for the all-T node."""
    k = 31
    rng = np.random.default_rng(4)
    reads = np.concatenate([np.full((1, 40), 3, np.uint8),
                            rng.integers(0, 4, (4, 40), dtype=np.uint8)])
    gj, gp = graph_pair(*spectrum(reads, k + 1), k)
    assert gp.lo[-1] == U64(2**64 - 1) and not gp.hi.any()
    all_t = np.array([(1 << 62) - 1], U64)
    nlo = np.concatenate([all_t, gp.from_node(gp.lo, gp.hi)[0]])
    nhi = np.zeros_like(nlo)
    r0, r1 = gp.begin_end_rank(nlo, nhi)
    assert r1[0] == gp.count and r1[0] - r0[0] == 1
    same(gj.begin_end_rank(nlo, nhi), (r0, r1))
    same(gj.node_degrees(nlo, nhi), gp.node_degrees(nlo, nhi))
    same(gj.successor_table(), gp.successor_table())


# ---------------------------------------- successor table and decomposition
def dec_tuple(d):
    return (d.start, d.pos, d.cyclic, d.order, d.seg_off, d.seg_len, d.seg_start)


@pytest.mark.parametrize("kind", list(KS))
def test_successor_table_and_decompose_match_jax(kind, form):
    gj, gp = graphs(kind)
    want = gj.successor_table()
    got = gp.successor_table()
    same(want, got)
    assert (got >= 0).any() and (got < 0).any()
    dj, dp = jseg.decompose(gj), pseg.decompose(gp)
    live = ~dj.cyclic
    # cycle edges: the native walk marks start -1, pointer doubling leaves
    # a member of the cycle; everything else is one decomposition
    same(dj.cyclic, dp.cyclic)
    same(dj.start[live], dp.start[live])
    same(dj.pos[live], dp.pos[live])
    same(dec_tuple(dj)[3:], dec_tuple(dp)[3:])
    assert len(dp.seg_start) > 10 and int(dp.seg_len.sum()) == len(dp.order)


@pytest.mark.parametrize("kind", list(KS))
def test_pointer_doubling_equals_native_chains(kind, monkeypatch):
    """The port's two forms of ``decompose`` against each other, on a graph
    with an isolated cycle."""
    k = KS[kind]
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 70, dtype=np.uint8)
    ring = np.tile(unit, 3)[None, : 70 + k + 1]  # rho-mers close into a cycle
    lo, hi, c = spectrum(noisy_reads(6), k + 1)
    rl, rh, rc = spectrum(ring, k + 1)
    lo, hi, c = (np.concatenate(p) for p in ((lo, rl), (hi, rh), (c, rc)))
    order = np.lexsort((lo, hi))
    gp = pgraph.Graph(k, lo[order], hi[order], c[order])
    with_native = pseg.decompose(gp)

    def unavailable():
        raise native.NativeUnavailable("made unavailable by the test")

    monkeypatch.setattr(native, "load_library", unavailable)
    doubled = pseg.decompose(gp)
    assert with_native.cyclic.sum() == 2 * 70 == doubled.cyclic.sum()
    live = ~doubled.cyclic
    same(with_native.start[live], doubled.start[live])
    same(with_native.pos[live], doubled.pos[live])
    same(dec_tuple(with_native)[2:], dec_tuple(doubled)[2:])


# ------------------------------------------------------------------ TrimView
@pytest.mark.parametrize("kind", list(KS))
def test_trim_view_matches_jax(kind, form):
    gj, gp = graphs(kind)
    vj, vp = jtrim.TrimView(gj), ptrim.TrimView(gp)
    rng = np.random.default_rng(7)
    nlo, nhi = some_nodes(gj, rng)
    rc = gj.edge_rc_rank()
    for _round in range(2):
        mask = rng.random(gj.count) < 0.15
        mask[rc[mask]] = True  # deletions come in reverse-complement pairs
        assert vj.zap(mask) == vp.zap(mask.copy())
        assert vj.live_count == vp.live_count < vp.count == gp.count
        same(vj.dead, vp.dead)
        for method in ("out_degree", "in_degree", "node_degrees",
                       "begin_end_rank", "from_node", "to_node", "node_rc"):
            same(getattr(vj, method)(nlo, nhi), getattr(vp, method)(nlo, nhi))
        same(vj.successor_table(), vp.successor_table())
        same(vj.edge_rc_rank(), vp.edge_rc_rank())
    fj, fp = vj.finalize(), vp.finalize()
    same((fj.lo, np.asarray(fj.hi), fj.counts), (fp.lo, np.asarray(fp.hi), fp.counts))
    assert (vp.k, vp.rho) == (gp.k, gp.rho) and fp.lint() == []


# ------------------------------------- the native forms at their thresholds
@functools.cache
def big_narrow():
    """40k edges: above the 2^14 nodes and 2^15 queries where the fused
    native queries and the native rank take over."""
    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, (1, 20_500), dtype=np.uint8)
    return graph_pair(*spectrum(genome, 16), 15)


def test_native_forms_equal_numpy_forms_above_thresholds(monkeypatch):
    gj, gp = big_narrow()
    assert gp.count >= 1 << 15
    nlo, nhi = gp.to_node(gp.lo, gp.hi)
    nat = (gp.node_degrees(nlo, nhi), gp.rank(gp.lo[::-1], gp.hi[::-1]),
           gp.rank(gp.lo, gp.hi), gp.successor_table())
    view = ptrim.TrimView(gp)
    dead = np.zeros(gp.count, bool)
    dead[::7] = True
    view.zap(dead)
    nat_view = view.node_degrees(nlo, nhi)
    same(gj.node_degrees(nlo, nhi), nat[0])

    def unavailable():
        raise native.NativeUnavailable("made unavailable by the test")

    monkeypatch.setattr(native, "load_library", unavailable)
    same(nat, (gp.node_degrees(nlo, nhi), gp.rank(gp.lo[::-1], gp.hi[::-1]),
               gp.rank(gp.lo, gp.hi), gp.successor_table()))
    same(nat_view, view.node_degrees(nlo, nhi))
    same(nat[2], np.arange(gp.count, dtype=np.int64))


@pytest.mark.parametrize("sorted_queries", [True, False])
def test_native_rank_u64(sorted_queries):
    rng = np.random.default_rng(9)
    a = np.unique(rng.integers(0, 1 << 40, 5000).astype(U64))
    q = np.concatenate([a[::3], rng.integers(0, 1 << 40, 3000).astype(U64)])
    q = np.sort(q) if sorted_queries else q
    got = native.native_rank_u64(a, q)
    same(got, np.searchsorted(a, q, side="left").astype(np.int64))


def test_native_queries_raise_without_the_library(monkeypatch):
    """The bindings raise; only ``native_or_none`` turns that into the
    numpy form, and nothing else is caught."""
    def unavailable():
        raise native.NativeUnavailable("made unavailable by the test")

    monkeypatch.setattr(native, "load_library", unavailable)
    a = np.arange(10, dtype=U64)
    with pytest.raises(native.NativeUnavailable):
        native.native_rank_u64(a, a)
    with pytest.raises(native.NativeUnavailable):
        native.native_chains(np.full(4, -1, np.int64))
    assert native.native_or_none("rank", native.native_rank_u64, a, a) is None

    def broken(*_a):
        raise ValueError("not the library's absence")

    with pytest.raises(ValueError):
        native.native_or_none("rank", broken, a, a)
    with pytest.raises(ValueError, match="2\\*rho <= 64"):
        native.native_successor_table(a, 40)


# ------------------------------------------------------------- text format
@pytest.mark.parametrize("kind", list(KS))
def test_dump_restore_graph_match_jax(kind):
    gj, gp = graphs(kind)
    out_j, out_p = io.StringIO(), io.StringIO()
    jtext.dump_graph(gj, out_j)
    ptext.dump_graph(gp, out_p)
    assert out_j.getvalue() == out_p.getvalue()
    back = ptext.restore_graph(io.StringIO(out_p.getvalue()))
    same((gp.lo, np.asarray(gp.hi), gp.counts),
         (back.lo, np.asarray(back.hi), back.counts))
    assert (back.k, back.asymmetric) == (gp.k, False)
    seqs = [bytes(row) for row in gp.edge_strings(np.arange(50))]
    same(jtext.pack_strings(seqs, gp.rho), ptext.pack_strings(seqs, gp.rho))
    with pytest.raises(ValueError, match="version"):
        ptext.restore_graph(io.StringIO("#1\n15\t0\t0\n"))
    with pytest.raises(ValueError, match="invalid base"):
        ptext.pack_strings([b"ACGN"], 4)
