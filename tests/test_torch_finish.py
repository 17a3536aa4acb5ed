"""The narrow engine's finish on the device, run here on CPU tensors: the
device merge of spilled runs (``merge_runs``), the host merge
(``transfer.host_merge``) and the device expansion (``expand_symmetric``)
against the JAX package's host finish (``gossamer_tpu.ops.count._host_merge``
/ ``_expand_symmetric``) and a ``np.unique`` sum, with int64 counts past
2^31 and 2^32, the engine's choice of side by the cap, and
``graph.build.build_graph`` against the JAX one.  Keys and counts must be
equal.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.graph.build import build_graph as jax_build_graph
from gossamer_tpu.io.readers import Read as JaxRead
from gossamer_tpu.ops.count import _expand_symmetric, _host_merge
from gossamer_tpu_torch.graph.build import build_graph
from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops.canon import canon_value, rc
from gossamer_tpu_torch.ops.fold import SENT
from gossamer_tpu_torch.ops.transfer import host_merge

CPU = torch.device("cpu")
RHO = 26


def _palindrome(rng, rho=RHO):
    """A rho-mer equal to its reverse complement (rho even)."""
    half = rng.integers(0, 4, rho // 2)
    bases = np.concatenate([half, 3 - half[::-1]])
    return int(sum(int(b) << (2 * (rho - 1 - i)) for i, b in enumerate(bases)))


def _classes(rng, n, rho=RHO, pal=2):
    """``n`` distinct canonical (min-by-value) keys, ascending, ``pal`` of
    them palindromes."""
    keys = torch.from_numpy(rng.integers(0, 1 << (2 * rho), n, dtype=np.int64))
    keys = torch.cat([keys, torch.tensor([_palindrome(rng) for _ in range(pal)])])
    keys = torch.unique(canon_value(keys, rho))
    assert int((rc(keys, rho) == keys).sum()) == pal
    return keys


def _spectrum(keys, counts, cap):
    pad = cap - keys.numel()
    return (torch.cat([keys, torch.full((pad,), SENT)]),
            torch.cat([counts, torch.zeros(pad, dtype=torch.int64)]))


def _jax_merge(a, b):
    """The JAX package's host merge of two ``(lo u64, c i64)`` runs."""
    lo, _hi, c = _host_merge((a[0], np.zeros_like(a[0]), a[1]),
                             (b[0], np.zeros_like(b[0]), b[1]))
    return lo, c


def _unique_sum(runs):
    """Independent oracle of a merge of runs: ``np.unique`` and an int64
    sum of the counts of each key."""
    lo = np.concatenate([r[0] for r in runs])
    keys, inv = np.unique(lo, return_inverse=True)
    c = np.zeros(len(keys), np.int64)
    np.add.at(c, inv, np.concatenate([r[1] for r in runs]))
    return keys, c


def test_merge_runs_matches_host_past_2_32():
    rng = np.random.default_rng(3)
    a, b = _classes(rng, 500), _classes(rng, 200)
    b = torch.unique(torch.cat([b, a[::4]]))
    ca = torch.from_numpy(rng.integers(1, 1 << 32, a.numel()))
    cb = torch.from_numpy(rng.integers(1, 1 << 32, b.numel()))
    both = int(a[0])
    ca[0] = (1 << 32) - 3
    cb[int((b == both).nonzero()[0])] = (1 << 32) - 7
    keys, counts = E.merge_runs(a, ca, b, cb)
    runs = [(a.numpy().view(np.uint64), ca.numpy()),
            (b.numpy().view(np.uint64), cb.numpy())]
    for want in (_jax_merge(*runs), _unique_sum(runs)):
        assert np.array_equal(keys.numpy().view(np.uint64), want[0])
        assert np.array_equal(counts.numpy(), want[1])
    host = host_merge(runs[0], runs[1])  # the port's host side
    assert np.array_equal(host[0], want[0]) and np.array_equal(host[1], want[1])
    assert int(counts[int((keys == both).nonzero()[0])]) == (1 << 33) - 10
    empty = torch.zeros(0, dtype=torch.int64)
    got = E.merge_runs(a, ca, empty, empty)
    assert torch.equal(got[0], a) and torch.equal(got[1], ca)


def test_expand_symmetric_matches_host_past_2_31():
    rng = np.random.default_rng(4)
    keys = _classes(rng, 1000, pal=3)
    counts = torch.from_numpy(rng.integers(1, 1 << 32, keys.numel()))
    pal = (rc(keys, RHO) == keys).nonzero()[:, 0]
    counts[pal[0]] = (1 << 31) + 5
    got = E.expand_symmetric(keys, counts, RHO)
    want = _expand_symmetric(keys.numpy().view(np.uint64), counts.numpy(), RHO)
    assert np.array_equal(got[0].numpy().view(np.uint64), want[0])
    assert np.array_equal(got[1].numpy(), want[2])
    assert got[1].dtype == torch.int64
    assert int(got[1][got[0] == keys[pal[0]]]) == (1 << 32) + 10


def _engine_with_runs(rng, cap, sizes=(300, 700)):
    """An engine whose spectrum holds a palindrome at 2^31 + 5 and whose
    spilled runs (of about ``sizes`` keys), with the spectrum, sum one key
    past 2^32."""
    eng = E.SpectrumEngine(RHO, "value", 1024, CPU, cap=cap)
    keys = _classes(rng, 900)
    counts = torch.from_numpy(rng.integers(1, 1 << 20, keys.numel()))
    counts[(rc(keys, RHO) == keys).nonzero()[0, 0]] = (1 << 31) + 5
    counts[0] = (1 << 32) - 1
    eng.start_from(*_spectrum(keys, counts, 1024))
    runs = []
    for n in sizes:
        run = torch.unique(torch.cat([_classes(rng, n), keys[:1]]))
        c = torch.from_numpy(rng.integers(1, 1 << 32, run.numel()))
        c[int((run == keys[0]).nonzero()[0])] = (1 << 32) - 2
        runs.append((run.numpy().view(np.uint64), c.numpy()))
        eng.host_runs.append(("raw", *runs[-1]))
    host = (keys.numpy().view(np.uint64), counts.numpy())
    for run in runs:  # smallest first, as the engine
        host = _jax_merge(run, host)
    want = _unique_sum(runs + [(keys.numpy().view(np.uint64), counts.numpy())])
    assert all(np.array_equal(h, w) for h, w in zip(host, want))
    return eng, host


@pytest.mark.parametrize("cap,sides", [
    (1 << 14, ("on cpu", "on cpu", "on cpu")),
    (1024, ("on the host", "on the host", "on the host")),
])
def test_engine_finish_matches_host(cap, sides):
    """The engine's finish merges the runs, smallest first, and expands on
    the device when the lanes fit the cap, else on the host; both equal the
    JAX package's host finish, counts in int64 (a sum past 2^32, a
    palindrome doubled past 2^32)."""
    eng, (lo, c) = _engine_with_runs(np.random.default_rng(5), cap)
    got = eng.finish()
    assert np.array_equal(got[0], lo) and np.array_equal(got[2], c)
    assert got[2].dtype == np.int64 and c.max() > 1 << 32
    assert eng.finish_log[0].startswith("merge of 303 + 703 keys")
    assert [s.endswith(w) for s, w in zip(eng.finish_log, sides)] == [True] * 2
    eng, _ = _engine_with_runs(np.random.default_rng(5), cap)
    got = eng.finish_expanded()
    want = _expand_symmetric(lo, c, RHO)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype
               for g, w in zip(got, want))
    assert got[2].max() > 1 << 32
    assert len(eng.finish_log) == 3
    assert eng.finish_log[2].startswith(f"expansion of {len(lo):,} keys")
    assert [s.endswith(w) for s, w in zip(eng.finish_log, sides)] == [True] * 3
    assert set(eng.phases) == {"flush_tail", "pull", "expand"}


def test_build_graph_matches_jax():
    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, 2000)
    seqs = []
    for _ in range(80):
        p = int(rng.integers(0, 1900))
        seqs.append(bytes(np.frombuffer(b"ACGT", np.uint8)[genome[p:p + 100]]))
    seqs[5] = seqs[5][:40] + b"N" + seqs[5][41:]
    for chunk in (4096, 1000):  # packed chunks, raw codes
        g = build_graph((Read(str(i), s) for i, s in enumerate(seqs)), 25,
                        device=CPU, chunk=chunk)
        j = jax_build_graph((JaxRead(str(i), s) for i, s in enumerate(seqs)),
                            25, chunk=chunk)
        assert g.k == j.k == 25 and len(g.lo) > 1000
        assert np.array_equal(g.lo, j.lo) and np.array_equal(g.hi, j.hi)
        assert np.array_equal(g.counts, j.counts)
        assert g.asymmetric == j.asymmetric is False


@pytest.mark.parametrize("cap,sides", [
    (1 << 14, ("on cpu", "on cpu")),
    (3000, ("on cpu", "on the host")),  # the lanes fit, twice them do not
    (1024, ("on the host", "on the host")),
])
def test_finish_side_is_chosen_once(cap, sides):
    """Three spilled runs and the spectrum (about 2,110 lanes): every step
    of ``finish`` runs on the side its lanes choose, every step of
    ``finish_expanded`` on the side twice its lanes choose; both equal
    the JAX package's host finish."""
    for expanded, side in zip((False, True), sides):
        eng, (lo, c) = _engine_with_runs(np.random.default_rng(7), cap,
                                         sizes=(200, 400, 600))
        assert len(eng.host_runs) == 3
        got = eng.finish_expanded() if expanded else eng.finish()
        want = _expand_symmetric(lo, c, RHO) if expanded else (lo, None, c)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[2], want[2]) and got[2].dtype == np.int64
        assert len(eng.finish_log) == 3 + expanded and eng.spec is None
        assert all(step.endswith(side) for step in eng.finish_log)
