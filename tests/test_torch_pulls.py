"""The narrow engine's pulls of a spectrum to the host and its one finish,
against the JAX engine.

The pulls (``_pull_planes``: delta, packed counts, exact; ``_delta_pack``,
``_slice_pieces_packed`` and the native delta decoder) against the JAX
functions on the live lanes.  The finish: the JAX engine with its early
pull on (a snapshot after a flush, the reconciled pull, the expansion by
the snapshot's order, and the stops of that route) is the oracle of the
port's one finish on the same chunks.  The JAX engine runs its XLA sort
path (``fold=False``); the chunks are made from a seed with numpy.
Outputs must be bit-identical, and the JAX engine must take the route the
case names (``_snap``, ``_last_reconcile``, ``phases["expand_path"]``).
Shapes are ``tests/test_engine.py``'s (rho 13, chunks of 2000, caps up to
2^15).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gossamer_tpu.io import native as jax_native
from gossamer_tpu.ops import engine as JE
from gossamer_tpu_torch.io import native as N
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


def _jax(chunks, expanded=False, rho=RHO, mode="value", **kw):
    """The JAX engine on ``chunks`` -> (engine, whether it held a snapshot
    before its finish, its output)."""
    je = JE.SpectrumEngine(rho, mode, 2000, fold=False, **kw)
    for c in chunks:
        je.add_chunk(c)
    snap = je._snap is not None
    return je, snap, je.finish_expanded() if expanded else je.finish()


def _port(chunks, expanded=False, rho=RHO, mode="value", **kw):
    """The port's engine on ``chunks`` -> (engine, its output)."""
    pe = E.SpectrumEngine(rho, mode, 2000, CPU, **kw)
    for c in chunks:
        pe.add_chunk(c)
    return pe, pe.finish_expanded() if expanded else pe.finish()


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


# ------------------------------------- the finish against the early pull
@pytest.mark.parametrize("hint", [False, True])
def test_early_pull_reconcile_parity(small_delta, hint):
    """The JAX engine's snapshot after flush 1 and ``finish()`` by the
    reconciled pull == the port's finish."""
    chunks = _chunks(np.random.default_rng(21), 8)
    je, snap, want = _jax(chunks, batch=2, cap=1 << 14, spill=False,
                          early_pull_flush=1,
                          expected_distinct=6000 if hint else None)
    assert snap and je._last_reconcile["n_new"] > 0
    pe, got = _port(chunks, batch=2, cap=1 << 14, spill=False)
    assert pe.spills == 0 and pe.finish_log == []
    _same(got, want)


def test_early_pull_invalidated_by_spill(small_delta):
    """A spill at the snapshot's flush: no snapshot in the JAX engine; both
    finishes merge the spilled runs."""
    chunks = _chunks(np.random.default_rng(22), 10)
    je, snap, want = _jax(chunks, batch=2, cap=4096, spill=True,
                          early_pull_flush=1)
    assert not snap and je._snap is None and je.spills >= 1
    pe, got = _port(chunks, batch=2, cap=4096, spill=True)
    assert pe.spills >= 1
    assert pe.finish_log[0].startswith("merge of")
    _same(got, want)


def test_early_pull_expanded_parity(small_delta):
    """The JAX engine's ``finish_expanded`` by the reconciled pull and the
    snapshot's expansion order == the port's, whose phases are its three
    scopes."""
    chunks = _chunks(np.random.default_rng(23), 6)
    je, _snap, want = _jax(chunks, True, batch=2, cap=1 << 14, spill=False,
                           early_pull_flush=2)
    assert je.phases["expand_path"] == "order"
    pe, got = _port(chunks, True, batch=2, cap=1 << 14, spill=False)
    _same(got, want)
    assert set(pe.phases) == {"flush_tail", "pull", "expand"}
    assert all(isinstance(v, float) for v in pe.phases.values())


def test_first_batch_moves_the_snapshot(small_delta):
    """The JAX engine's smaller first flush puts its snapshot after one
    chunk; the port flushes 3 chunks at a time from the start."""
    chunks = _chunks(np.random.default_rng(24), 7)
    je, snap, want = _jax(chunks, True, batch=3, first_batch=1, cap=1 << 14,
                          spill=False, early_pull_flush=1,
                          expected_distinct=9000)
    rec = je._last_reconcile
    assert snap and rec["n1"] < 2000 < rec["n_new"]
    _pe, got = _port(chunks, True, batch=3, cap=1 << 14, spill=False)
    _same(got, want)


def test_ref_mode_through_finish(small_delta):
    chunks = _chunks(np.random.default_rng(25), 6)
    je, snap, want = _jax(chunks, mode="ref", batch=2, cap=1 << 14,
                          spill=False, early_pull_flush=1)
    assert snap and je._last_reconcile is not None
    _pe, got = _port(chunks, mode="ref", batch=2, cap=1 << 14, spill=False)
    _same(got, want)


def test_expansion_without_an_order_is_full(small_delta, monkeypatch):
    """Without the native expansion order the JAX engine expands in full;
    the port's expansion gives the same spectrum."""
    monkeypatch.setattr(jax_native, "native_expand_order", lambda *a: None)
    chunks = _chunks(np.random.default_rng(26), 6)
    je, _snap, want = _jax(chunks, True, batch=2, cap=1 << 14, spill=False,
                           early_pull_flush=1)
    assert je.phases["expand_path"] == "full"
    pe, got = _port(chunks, True, batch=2, cap=1 << 14, spill=False)
    _same(got, want)
    assert pe.finish_log[-1].startswith("expansion of ")


@pytest.mark.parametrize("expanded", [False, True])
def test_more_new_keys_than_exc_cap_falls_back(small_delta, monkeypatch,
                                               expanded):
    """More new keys after the JAX engine's snapshot than the port's
    exception cap (lowered to 1,024): the port's finish, whose pull on the
    host side stays within that cap, == the JAX engine's reconciled one."""
    monkeypatch.setattr(E, "_EXC_CAP", 1024)
    chunks = _chunks(np.random.default_rng(28), 8)
    je, snap, want = _jax(chunks, expanded, batch=2, cap=1 << 14, spill=False,
                          early_pull_flush=1)
    assert snap and je._last_reconcile["n_new"] > 1024
    pe, got = _port(chunks, expanded, batch=2, cap=1 << 14, spill=False)
    _same(got, want)
    n_out = int(pe.finish_log[-1].split()[2].replace(",", "")) if expanded \
        else len(got[0])
    # twice the 12,395 keys pass the cap: the expansion runs on the host,
    # its spectrum pulled through _pull_planes
    assert pe.finish_log == ([] if not expanded else
                             [f"expansion of {n_out:,} keys on the host"])
    assert pe.pulls == ([] if not expanded else
                        [f"{n_out:,} keys: delta, 1 exceptions"])


def test_sparse_key_space_takes_no_snapshot(small_delta):
    """rho 26 with a few thousand keys: too sparse for 32-bit deltas, so
    the JAX engine takes no snapshot; the finishes agree."""
    chunks = _chunks(np.random.default_rng(29), 4, rho=26)
    _je, snap, want = _jax(chunks, True, rho=26, batch=2, cap=1 << 14,
                           spill=False, early_pull_flush=1)
    assert not snap
    _pe, got = _port(chunks, True, rho=26, batch=2, cap=1 << 14, spill=False)
    _same(got, want)


# ------------------------------------------------------------------ pulls
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


@pytest.mark.parametrize("name", ["delta_unpack"])
def test_binding_matches_numpy_form(name):
    """The native delta decoder == its numpy form == the spectrum."""
    lo, counts = _wide_deltas(np.random.default_rng(5), 4000)
    keys, cc, _planes = _spectrum(lo, counts, 1 << 12)
    d, cpack, exc, n_exc = (t.numpy() for t in E._delta_pack(keys, cc))
    args = (d.view(np.uint32), cpack, *exc.view(np.uint32)[:, :int(n_exc)],
            len(lo))
    got = getattr(N, f"native_{name}")(*args)
    want = getattr(N, f"{name}_plain")(*args)
    assert np.array_equal(want[0], lo) and np.array_equal(want[1], counts)
    _equal(got, want)
