"""The narrow engine's early pull against the JAX engine: the snapshot after a
flush (``snapshot_async``), the reconciled finish (``_pull_reconciled``,
``_pull_reconciled_expanded`` by the snapshot's expansion order), its stops
and the finish without it, and the pulls of spilled spectra
(``_pull_planes``: delta, packed counts, exact).  The JAX engine runs its
XLA sort path (``fold=False``); the same chunks, made from a seed with
numpy, go through both.  Outputs must be bit-identical and both engines
must take the same route: JAX's ``_snap``, ``_last_reconcile`` and
``phases["expand_path"]`` against the port's ``finish_log``.  The codecs
(``_delta_pack``, ``_count_pack``, ``_reconcile_new_keys``,
``_slice_pieces_packed``) against the JAX functions on the live lanes, and
the five native bindings of the host tail against their numpy forms.
Shapes are ``tests/test_engine.py``'s (rho 13, chunks of 2000, caps up to
2^15).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gossamer_tpu.io import native as jax_native
from gossamer_tpu.ops import count as jax_count
from gossamer_tpu.ops import engine as JE
from gossamer_tpu_torch.io import native as N
from gossamer_tpu_torch.ops import count as C
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops.fold import SENT

CPU = torch.device("cpu")
RHO = 13  # 2 * rho <= 31: every spectrum is dense enough for the delta pull


def _chunks(rng, n_chunks, chunk=2000, rho=RHO, sep_every=50):
    """``tests/test_engine.py``'s raw chunks: random bases, ~2% separators."""
    out = []
    for _ in range(n_chunks):
        c = rng.integers(0, 4, size=chunk + rho - 1, dtype=np.uint8)
        c[rng.integers(0, len(c), size=len(c) // sep_every)] = 255
        out.append(c)
    return out


@pytest.fixture
def small_delta(monkeypatch):
    """``_DELTA_MIN`` at 16 in both packages (``tests/test_engine.py``)."""
    monkeypatch.setattr(JE, "_DELTA_MIN", 16)
    monkeypatch.setattr(E, "_DELTA_MIN", 16)


def _run(eng, chunks, expanded):
    for c in chunks:
        eng.add_chunk(c)
    snap = eng._snap is not None
    return snap, eng.finish_expanded() if expanded else eng.finish()


def _both(chunks, expanded=False, rho=RHO, mode="value", **kw):
    """The JAX and the port engine on ``chunks`` -> (jax engine, its
    output, whether it held a snapshot, the same three of the port)."""
    je = JE.SpectrumEngine(rho, mode, 2000, fold=False, **kw)
    pe = E.SpectrumEngine(rho, mode, 2000, CPU, **kw)
    return (je, *_run(je, chunks, expanded)[::-1],
            pe, *_run(pe, chunks, expanded)[::-1])


def _without(chunks, expanded=False, rho=RHO, mode="value", **kw):
    """The port engine's output without the early pull."""
    eng = E.SpectrumEngine(rho, mode, 2000, CPU, **kw)
    return _run(eng, chunks, expanded)[1]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _same(got, want):
    assert len(got) == 3
    _equal(got, want)


def _distinct(rng, bits, n):
    """``n`` distinct random keys of ``bits`` bits, ascending."""
    keys = np.unique(rng.integers(0, 1 << bits, 2 * n, dtype=np.int64))
    return np.sort(rng.choice(keys, n, replace=False)).astype(np.uint64)


def _reconciled(log):
    """(n1, n_new) of the port's reconciled pull, read from ``finish_log``."""
    for step in log:
        m = re.match(r"reconciled pull of [\d,]+ keys: n1 ([\d,]+) from the "
                     r"snapshot, n_new ([\d,]+)$", step)
        if m:
            return tuple(int(x.replace(",", "")) for x in m.groups())
    return None


def _no_fallback(monkeypatch, eng):
    def boom(*a, **k):
        raise AssertionError("the finish without the early pull ran")

    monkeypatch.setattr(eng, "_finish_runs", boom)


# ------------------------------------------------------- engine parity
@pytest.mark.parametrize("hint", [False, True])
def test_early_pull_reconcile_parity(small_delta, monkeypatch, hint):
    """Snapshot after flush 1, ``finish()`` by the reconciled pull: the
    same keys reconciled as the JAX engine's, the same output, equal to the
    finish without the early pull."""
    chunks = _chunks(np.random.default_rng(21), 8)
    kw = dict(batch=2, cap=1 << 14, spill=False, early_pull_flush=1,
              expected_distinct=6000 if hint else None)
    pe = E.SpectrumEngine(RHO, "value", 2000, CPU, **kw)
    for c in chunks:
        pe.add_chunk(c)
    assert pe._snap is not None and pe._prex is not None
    _no_fallback(monkeypatch, pe)
    got = pe.finish()
    je = JE.SpectrumEngine(RHO, "value", 2000, fold=False, **kw)
    snap, want = _run(je, chunks, False)
    assert snap
    _same(got, want)
    rec = je._last_reconcile
    assert _reconciled(pe.finish_log) == (rec["n1"], rec["n_new"])
    assert rec["n_new"] > 0 and pe._snap is None and pe._prex_pool is None
    _same(got, _without(chunks, batch=2, cap=1 << 14))


def test_early_pull_invalidated_by_spill(small_delta):
    """A spill at the snapshot's flush: no snapshot in either engine, the
    finish merges the spilled runs, output as without the early pull."""
    chunks = _chunks(np.random.default_rng(22), 10)
    je, want, j_snap, pe, got, p_snap = _both(
        chunks, batch=2, cap=4096, spill=True, early_pull_flush=1)
    assert not j_snap and not p_snap and je._snap is None
    assert pe.spills >= 1 and je.spills >= 1
    assert pe.finish_log[0] == "early pull at flush 1: no snapshot (spilled runs)"
    _same(got, want)
    _same(got, _without(chunks, batch=2, cap=1 << 15))


def test_early_pull_expanded_parity(small_delta, monkeypatch):
    """``finish_expanded`` by the reconciled pull and the snapshot's
    expansion order, as the JAX engine's "order" path."""
    chunks = _chunks(np.random.default_rng(23), 6)
    kw = dict(batch=2, cap=1 << 14, spill=False, early_pull_flush=2)
    pe = E.SpectrumEngine(RHO, "value", 2000, CPU, **kw)
    for c in chunks:
        pe.add_chunk(c)
    _no_fallback(monkeypatch, pe)
    got = pe.finish_expanded()
    je = JE.SpectrumEngine(RHO, "value", 2000, fold=False, **kw)
    _snap, want = _run(je, chunks, True)
    _same(got, want)
    assert je.phases["expand_path"] == "order"
    assert pe.finish_log[-1].endswith("on the host: order")
    rec = je._last_reconcile
    assert _reconciled(pe.finish_log) == (rec["n1"], rec["n_new"])
    assert all(isinstance(v, float) for v in pe.phases.values())
    assert {"sync", "reconcile", "fin_get", "prex_wait", "exp_split",
            "exp_apply", "exp_merge", "expand"} <= set(pe.phases)
    _same(got, _without(chunks, True, batch=2, cap=1 << 14))


def test_first_batch_moves_the_snapshot(small_delta):
    """A smaller first flush: the snapshot after one chunk, fewer keys in
    it, as in the JAX engine."""
    chunks = _chunks(np.random.default_rng(24), 7)
    je, want, j_snap, pe, got, p_snap = _both(
        chunks, True, batch=3, first_batch=1, cap=1 << 14, spill=False,
        early_pull_flush=1, expected_distinct=9000)
    assert j_snap and p_snap
    _same(got, want)
    rec = je._last_reconcile
    assert _reconciled(pe.finish_log) == (rec["n1"], rec["n_new"])
    assert rec["n1"] < 2000 < rec["n_new"]
    _same(got, _without(chunks, True, batch=3, first_batch=1, cap=1 << 14))


def test_ref_mode_through_finish(small_delta):
    chunks = _chunks(np.random.default_rng(25), 6)
    je, want, j_snap, pe, got, p_snap = _both(
        chunks, mode="ref", batch=2, cap=1 << 14, spill=False,
        early_pull_flush=1)
    assert j_snap and p_snap
    _same(got, want)
    rec = je._last_reconcile
    assert _reconciled(pe.finish_log) == (rec["n1"], rec["n_new"])
    _same(got, _without(chunks, mode="ref", batch=2, cap=1 << 14))


def test_expansion_without_an_order_is_full(small_delta, monkeypatch):
    """Without the native expansion order both engines expand in full."""
    def unavailable(*a):
        raise N.NativeUnavailable("turned off")

    monkeypatch.setattr(jax_native, "native_expand_order", lambda *a: None)
    monkeypatch.setattr(N, "native_expand_order", unavailable)
    chunks = _chunks(np.random.default_rng(26), 6)
    je, want, _j, pe, got, _p = _both(
        chunks, True, batch=2, cap=1 << 14, spill=False, early_pull_flush=1)
    _same(got, want)
    assert je.phases["expand_path"] == "full"
    assert pe.finish_log[-1].endswith("on the host: full")


def test_reconciled_tail_numpy_forms(small_delta, monkeypatch):
    """The host tail's numpy forms (no native split, apply, insert merge or
    delta decoder) give the same output by the same route."""
    def unavailable(*a):
        raise N.NativeUnavailable("turned off")

    for name in ("native_split_counts", "native_apply_order",
                 "native_insert_merge", "native_delta_unpack"):
        monkeypatch.setattr(N, name, unavailable)
    chunks = _chunks(np.random.default_rng(27), 6)
    je, want, _j, pe, got, _p = _both(
        chunks, True, batch=2, cap=1 << 14, spill=False, early_pull_flush=1)
    _same(got, want)
    assert je.phases["expand_path"] == "order"
    assert pe.finish_log[-1].endswith("on the host: order")


@pytest.mark.parametrize("expanded", [False, True])
def test_more_new_keys_than_exc_cap_falls_back(small_delta, monkeypatch,
                                               expanded):
    """More new keys than ``_EXC_CAP`` (the port's constant lowered; the JAX
    codecs read theirs when traced): the reconciled pull stops, says why,
    and the finish runs without it."""
    monkeypatch.setattr(E, "_EXC_CAP", 1024)
    chunks = _chunks(np.random.default_rng(28), 8)
    pe = E.SpectrumEngine(RHO, "value", 2000, CPU, batch=2, cap=1 << 14,
                          spill=False, early_pull_flush=1)
    snap, got = _run(pe, chunks, expanded)
    assert snap and _reconciled(pe.finish_log) is None
    m = re.match(r"reconciled pull stopped: n1 ([\d,]+), n_new ([\d,]+) of "
                 r"([\d,]+) keys \(at most 1,024 new keys\); the finish "
                 r"without the early pull$", pe.finish_log[0])
    n1, n_new, n_out = (int(x.replace(",", "")) for x in m.groups())
    assert n_new == n_out - n1 > 1024
    # twice the 12,395 keys pass the cap: the expansion runs on the host,
    # its spectrum pulled through _pull_planes
    assert len(pe.finish_log) == 1 + expanded
    assert pe.finish_log[-1].endswith("the early pull" if not expanded
                                      else "on the host")
    assert pe.pulls == ([] if not expanded else
                        [f"{n_out:,} keys: delta, 1 exceptions"])
    _same(got, _without(chunks, expanded, batch=2, cap=1 << 14))


def test_sparse_key_space_takes_no_snapshot(small_delta):
    """rho 26 with a few thousand keys: too sparse for 32-bit deltas."""
    chunks = _chunks(np.random.default_rng(29), 4, rho=26)
    je, want, j_snap, pe, got, p_snap = _both(
        chunks, True, rho=26, batch=2, cap=1 << 14, spill=False,
        early_pull_flush=1)
    assert not j_snap and not p_snap
    assert re.fullmatch(r"early pull at flush 1: no snapshot \([\d,]+ keys: "
                        r"a sparse key space\)", pe.finish_log[0])
    _same(got, want)


def test_count_chunks_leaves_early_pull_off(monkeypatch):
    """The CLI's count builds its engine without the early pull, as the JAX
    CLI off the TPU."""
    engines = []

    class Spy(E.SpectrumEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(C, "SpectrumEngine", Spy)
    chunks = _chunks(np.random.default_rng(30), 3, rho=26)
    got = C.count_chunks(iter(chunks), 26, both_strands=True, canonical=False,
                         device=CPU, chunk=0, cap_entries=1 << 14)
    want = jax_count.count_chunks(iter(chunks), 26, both_strands=True,
                                  canonical=False, cap_entries=1 << 14)
    assert len(engines) == 1 and engines[0].early_pull_flush is None
    assert engines[0].expected_distinct is None
    _same(got, want)


def test_spilled_spectrum_uses_delta_pull(monkeypatch):
    """A spill pulls a dense spectrum delta-packed; the count equals a
    brute-force count (``tests/test_delta_pull.py``'s shape)."""
    monkeypatch.setattr(E, "_DELTA_MIN", 1)
    rho, chunk = 12, 1 << 15
    rng = np.random.default_rng(1)
    chunks = [rng.integers(0, 4, size=chunk + rho - 1, dtype=np.uint8)
              for _ in range(3)]
    eng = E.SpectrumEngine(rho, "plain", chunk, CPU, batch=1, cap=1 << 16)
    for c in chunks:
        eng.add_chunk(c)
    lo, _hi, c = eng.finish()
    assert eng.spills == 1 and re.fullmatch(
        r"[\d,]+ keys: delta, 1 exceptions", eng.pulls[0])
    w = np.concatenate([np.lib.stride_tricks.sliding_window_view(
        ch.astype(np.uint64), rho) for ch in chunks])
    keys = (w << (np.uint64(2) * np.arange(rho - 1, -1, -1, dtype=np.uint64))
            ).sum(axis=1, dtype=np.uint64)
    want_lo, want_c = np.unique(keys, return_counts=True)
    assert np.array_equal(lo, want_lo) and np.array_equal(c, want_c)


# ---------------------------------------------------------------- codecs
def _spectrum(lo64, counts, cap):
    """A port spectrum (int64 keys, sentinel tail) and JAX's three u32
    planes of the same lanes."""
    n = len(lo64)
    keys = np.full(cap, SENT, np.int64)
    keys[:n] = lo64.view(np.int64)
    c = np.zeros(cap, np.int64)
    c[:n] = counts
    l1 = np.full(cap, 0xFFFFFFFF, np.uint32)
    l0 = l1.copy()
    l1[:n] = (lo64 >> np.uint64(32)).astype(np.uint32)
    l0[:n] = lo64.astype(np.uint32)
    planes = tuple(jnp.asarray(x) for x in (l1, l0, c.astype(np.uint32)))
    return torch.from_numpy(keys), torch.from_numpy(c), planes


def _wide_deltas(rng, n):
    """``tests/test_delta_pull.py``'s keys: small deltas, 37 of 2^33 or
    more; counts up to 200, 23 of 255 or more."""
    deltas = rng.integers(1, 1 << 20, size=n).astype(np.uint64)
    wide = rng.choice(n, size=37, replace=False)
    deltas[wide] = (np.uint64(1) << np.uint64(33)) + rng.integers(
        0, 1 << 10, size=37).astype(np.uint64)
    counts = rng.integers(1, 200, size=n).astype(np.int64)
    big = rng.choice(n, size=23, replace=False)
    counts[big] = rng.integers(255, 1 << 20, size=23)
    return np.cumsum(deltas).astype(np.uint64), counts


@pytest.mark.parametrize("case", ["exceptions", "dense"])
def test_delta_pack_round_trip_matches_jax(case):
    """The port's delta plane, count bytes and exception rows == JAX's on
    the live lanes, and they decode to the spectrum."""
    cap = 1 << 14
    if case == "exceptions":
        n = 5000
        lo, counts = _wide_deltas(np.random.default_rng(0), n)
    else:
        n = cap - 7
        lo = np.arange(n, dtype=np.uint64) * np.uint64(97) + np.uint64(5)
        counts = np.full(n, 3, np.int64)
    keys, c, planes = _spectrum(lo, counts, cap)
    d, cpack, exc, n_exc = E._delta_pack(keys, c)
    pieces, excp, j_nexc = JE._delta_pack(*planes, cap)
    n_exc = int(n_exc)
    assert n_exc == int(j_nexc) == (1 + 37 + 23 if case == "exceptions" else 1)
    d = d.numpy().view(np.uint32)
    assert np.array_equal(d[:n], np.asarray(pieces[0])[:n])
    assert np.array_equal(cpack.numpy()[:n],
                          np.asarray(pieces[1]).view(np.uint8)[:n])
    j_exc = np.concatenate([np.asarray(p) for p in excp], axis=1)
    exc = exc.numpy().view(np.uint32)
    assert np.array_equal(exc[:, :n_exc], j_exc[:, :n_exc])
    got_lo, got_c = E._delta_unpack(d, cpack.numpy(), exc, n_exc, n)
    assert np.array_equal(got_lo, lo) and np.array_equal(got_c, counts)


def test_count_pack_matches_jax():
    rng = np.random.default_rng(2)
    cap, n = 1 << 13, 6000
    lo = _distinct(rng, 26, n)
    counts = rng.integers(1, 300, n)
    keys, c, planes = _spectrum(lo, counts, cap)
    cpack, exc, n_exc = E._count_pack(keys, c)
    j_cp, j_excp, j_nexc = JE._count_pack(*planes, cap)
    n_exc = int(n_exc)
    assert n_exc == int(j_nexc) == int((counts >= 255).sum())
    assert np.array_equal(cpack.numpy()[:n],
                          np.asarray(j_cp[0]).view(np.uint8)[:n])
    exc = exc.numpy().view(np.uint32)
    j_exc = np.concatenate([np.asarray(p) for p in j_excp], axis=1)
    assert np.array_equal(exc[:, :n_exc], j_exc[:, :n_exc])
    assert np.array_equal(E._counts_from_pack(cpack.numpy(), exc, n_exc, n),
                          counts)


def test_reconcile_new_keys_matches_jax():
    rng = np.random.default_rng(3)
    cap = 1 << 13
    final = _distinct(rng, 40, 7000)
    snap = np.sort(rng.choice(final, 5200, replace=False))
    s_keys, _c, s_planes = _spectrum(snap, np.ones(len(snap), np.int64), cap)
    f_keys, _c, f_planes = _spectrum(final, np.ones(len(final), np.int64), cap)
    new, n_new = E._reconcile_new_keys(s_keys, f_keys)
    j_rows, j_new = JE._reconcile_new_keys(*s_planes[:2], *f_planes[:2], cap)
    n_new = int(n_new)
    assert n_new == int(j_new) == 1800
    j_rows = np.concatenate([np.asarray(p) for p in j_rows], axis=1)
    j_keys = (j_rows[1, :n_new].astype(np.uint64) << np.uint64(32)) | j_rows[2, :n_new]
    assert np.array_equal(new.numpy()[:n_new].view(np.uint64), j_keys)
    assert np.array_equal(j_keys, np.setdiff1d(final, snap))
    assert bool((new[n_new:] == SENT).all())


@pytest.mark.parametrize("rho,route", [
    (13, "packed counts"), (20, "packed counts"),
    (28, "packed counts, the counts again (one saturates)"), (30, "exact"),
    (13, "delta, 2 exceptions")])
def test_pull_planes_matches_jax(monkeypatch, rho, route):
    """The pull of a spilled spectrum by JAX's rule: counts packed into the
    keys' high bits up to rho 28 (8 count bits at 28, so a count of 255 has
    the counts pulled again), exact above, delta when large enough."""
    if route.startswith("delta"):
        monkeypatch.setattr(E, "_DELTA_MIN", 16)
        monkeypatch.setattr(JE, "_DELTA_MIN", 16)
    rng = np.random.default_rng(rho)
    cap, n = 1 << 13, 5000
    lo = _distinct(rng, 2 * rho, n)
    counts = rng.integers(1, 200, n)
    counts[n // 2] = 255
    keys, c, planes = _spectrum(lo, counts, cap)
    pe = E.SpectrumEngine(rho, "plain", 2000, CPU)
    got = pe._pull_planes((keys, c), n)
    want = JE.SpectrumEngine(rho, "plain", 2000, fold=False)._pull_planes(
        planes, n)
    _same(got, want)
    assert pe.pulls == [f"{n:,} keys: {route}"]
    assert np.array_equal(got[0], lo) and np.array_equal(got[2], counts)


def test_slice_pieces_packed_matches_jax():
    rho, cap, n = 26, 1 << 13, 3000
    rng = np.random.default_rng(4)
    lo = _distinct(rng, 2 * rho, n)
    counts = rng.integers(1, 5000, n)
    keys, c, planes = _spectrum(lo, counts, cap)
    p1, l0 = E._slice_pieces_packed(keys[:n], c[:n], 2 * rho - 32)
    want = JE._slice_pieces_packed(*planes, 2 * rho - 32)
    assert np.array_equal(p1.numpy().view(np.uint32), np.asarray(want[0])[:n])
    assert np.array_equal(l0.numpy().view(np.uint32), np.asarray(want[1])[:n])


# -------------------------------------------------------------- bindings
BIND_RHO = 12  # even: palindromes exist


def _classes(rng, n, rho=BIND_RHO):
    """Ascending canonical (min-by-value) classes, two palindromes among
    them, and counts past 2^32."""
    from gossamer_tpu_torch.core import kmer as K

    half = rng.integers(0, 4, (2, rho // 2)).astype(np.uint64)
    bases = np.concatenate([half, 3 - half[:, ::-1]], axis=1)
    pal = (bases << (np.uint64(2) * np.arange(rho - 1, -1, -1, dtype=np.uint64))
           ).sum(axis=1, dtype=np.uint64)
    keys = np.concatenate([rng.integers(0, 1 << (2 * rho), n).astype(np.uint64),
                           pal])
    rc, _ = K.reverse_complement(keys, np.zeros_like(keys), rho)
    keys = np.unique(np.minimum(keys, rc))
    rc, _ = K.reverse_complement(keys, np.zeros_like(keys), rho)
    assert int((rc == keys).sum()) >= 2
    return keys, rng.integers(1, 1 << 33, len(keys))


def _expand_order_numpy(lo, rho):
    """The expansion order by numpy: the classes and the reverse
    complements of the non-palindromes, sorted stably."""
    from gossamer_tpu_torch.core import kmer as K

    rlo, _ = K.reverse_complement(lo, np.zeros_like(lo), rho)
    pal = rlo == lo
    src = np.concatenate([np.arange(len(lo)), np.flatnonzero(~pal)])
    out = np.concatenate([lo, rlo[~pal]])
    order = np.argsort(out, kind="stable")
    return out[order], src[order], np.concatenate(
        [pal, np.zeros(int((~pal).sum()), bool)])[order]


@pytest.mark.parametrize("name", ["expand_order", "apply_order",
                                  "split_counts", "insert_merge",
                                  "delta_unpack"])
def test_binding_matches_numpy_form(name):
    rng = np.random.default_rng(5)
    lo, c = _classes(rng, 3000)
    if name == "expand_order":
        got = N.native_expand_order(lo, BIND_RHO)
        want = _expand_order_numpy(lo, BIND_RHO)
        assert got[2].any()
    elif name == "apply_order":
        _out, src, dbl = N.native_expand_order(lo, BIND_RHO)
        args = (src, dbl, c)
        got, want = N.native_apply_order(*args), N.apply_order_plain(*args)
    elif name == "split_counts":
        new = np.sort(rng.choice(len(lo), 300, replace=False))
        snap = np.setdiff1d(np.arange(len(lo)), new)
        idx = np.searchsorted(lo[snap], lo[new])
        args = (idx, c, len(snap), len(new))
        got, want = N.native_split_counts(*args), N.split_counts_plain(*args)
        assert np.array_equal(want[0], c[snap]) and np.array_equal(want[1], c[new])
    elif name == "insert_merge":
        new = np.sort(rng.choice(len(lo), 300, replace=False))
        base = np.setdiff1d(np.arange(len(lo)), new)
        args = (lo[base], c[base], lo[new], c[new])
        got, want = N.native_insert_merge(*args), N.insert_merge_plain(*args)
        assert np.array_equal(want[0], lo) and np.array_equal(want[1], c)
    else:
        lo, counts = _wide_deltas(rng, 4000)
        keys, cc, _planes = _spectrum(lo, counts, 1 << 12)
        d, cpack, exc, n_exc = (t.numpy() for t in E._delta_pack(keys, cc))
        args = (d.view(np.uint32), cpack, *exc.view(np.uint32)[:, :int(n_exc)],
                len(lo))
        got, want = N.native_delta_unpack(*args), N.delta_unpack_plain(*args)
        assert np.array_equal(want[0], lo) and np.array_equal(want[1], counts)
    _equal(got, want)


def test_expand_order_then_apply_is_the_expansion():
    """``native_expand_order`` then ``native_apply_order`` == the port's
    ``_expand_symmetric`` == the JAX package's."""
    lo, c = _classes(np.random.default_rng(6), 4000)
    out_lo, src, dbl = N.native_expand_order(lo, BIND_RHO)
    out_c = N.native_apply_order(src, dbl, c)
    want = C._expand_symmetric(lo, c, BIND_RHO)
    _same((out_lo, np.zeros_like(out_lo), out_c), want)
    _same(want, jax_count._expand_symmetric(lo, c, BIND_RHO))
