"""Pulls from the card to host memory: ``ops/transfer.py`` ``planes_to_host``
(and ``to_host``, ``run_to_host`` and ``ops/engine.py`` ``_pull_planes``
over it), ``ops/engine_wide.py`` ``u64_from_lanes`` and ``_pull``.

On the CPU: a CPU tensor comes back as its ``.numpy()``, counted under
``#d2h_bytes`` and not ``#d2h_pinned_bytes``; the carving of one block
into aligned views; every pull route of the narrow engine and the wide
engine's gives the spectrum's keys and counts; the finishes' outputs are
the same spectra as a brute-force count.  On the card (marker ``cuda``,
skipped without one): the arrays live in page-locked memory of their own,
equal per-plane ``.cpu()`` copies, and every byte of a finish's pulls is
pinned.  No JAX here, so the card cases run on a machine without it:
``python -m pytest tests/test_torch_to_host.py -q -m cuda --noconftest``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gossamer_tpu_torch.io.readers import Read
from gossamer_tpu_torch.io.stream import flat_code_chunks
from gossamer_tpu_torch.ops import engine as E
from gossamer_tpu_torch.ops import engine_wide as EW
from gossamer_tpu_torch.ops import transfer as T
from gossamer_tpu_torch.ops.fold import SENT
from gossamer_tpu_torch.utils import profile

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
DTYPES = [torch.int64, torch.int32, torch.uint8, torch.bool]


@pytest.fixture(autouse=True)
def profile_on():
    profile.reset()
    profile.enable()
    yield
    profile.enable(False)
    profile.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned host memory)")
    return torch.device("cuda")


def sample(dtype, shape=(1000,), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g).bool()
    hi = 256 if dtype == torch.uint8 else 1 << 31
    return torch.randint(0, hi, shape, generator=g).to(dtype)


def base_tensor(a: np.ndarray) -> torch.Tensor:
    """The tensor at the end of an array's chain of bases."""
    while isinstance(a, np.ndarray):
        a = a.base
    assert isinstance(a, torch.Tensor)
    return a


def counters() -> dict:
    return {k: v for k, v in profile.totals().items() if k.startswith("#")}


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("shape", [(1000,), (0,), (), (4, 250)],
                         ids=["vector", "empty", "scalar", "matrix"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_pull_is_the_tensors_numpy(dtype, shape):
    t = sample(dtype, shape)
    got = T.to_host(t)
    want = t.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert t.numel() == 0 or np.shares_memory(got, want)  # as .cpu().numpy()


def test_cpu_pull_counts_no_pinned_bytes():
    ts = [sample(d, seed=i) for i, d in enumerate(DTYPES)]
    T.to_host(ts[0])
    T.planes_to_host(*ts[1:])
    assert counters() == {"#d2h_bytes": sum(t.nbytes for t in ts)}
    assert "to_host" in profile.totals()


@pytest.mark.parametrize("sizes", [[5, 0, 1, 3, 8], [64], [0], [1, 63, 65, 128]],
                         ids=["mixed", "one-line", "empty", "edges"])
def test_carve_gives_aligned_disjoint_views(sizes):
    dtypes = [DTYPES[i % len(DTYPES)] for i in range(len(sizes))]
    ts = [sample(d, (n,), seed=i) for i, (d, n) in enumerate(zip(dtypes, sizes))]
    size = sum(T.aligned(t.nbytes) for t in ts)
    block = torch.zeros(size, dtype=torch.uint8)
    views = T.carve(block, ts)
    ends = []
    for v, t in zip(views, ts):
        assert v.dtype == t.dtype and v.shape == t.shape
        start = v.storage_offset() * v.element_size()
        assert start % T.ALIGN == 0 and start + t.nbytes <= size
        ends.append((start, start + t.nbytes))
        v.copy_(t)
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    for v, t in zip(views, ts):
        assert torch.equal(v, t)


def spectrum(keys: np.ndarray, counts: np.ndarray, cap: int, device):
    pad = cap - len(keys)
    return (torch.from_numpy(np.concatenate([keys, np.full(pad, SENT)]))
            .to(device),
            torch.from_numpy(np.concatenate([counts, np.zeros(pad, np.int64)]))
            .to(device))


# rho, keys, key space, the count's ceiling -> the route of _pull_planes
ROUTES = {"delta": (13, 600_000, 1 << 26, 300, "delta"),
          "packed": (26, 5_000, 1 << 52, 4_000, "packed counts"),
          "packed-saturated": (26, 5_000, 1 << 52, 5_000, "the counts again"),
          "exact": (31, 5_000, 1 << 62, 1 << 40, "exact")}


def route_case(name, device):
    rho, n, space, top, said = ROUTES[name]
    rng = np.random.default_rng(len(name))
    keys = np.unique(rng.integers(0, space, n, dtype=np.int64))
    counts = rng.integers(1, top, len(keys), dtype=np.int64)
    eng = E.SpectrumEngine(rho, "value", 1024, device)
    return eng, keys, counts, spectrum(keys, counts, len(keys) + 7, device), said


@pytest.mark.parametrize("name", list(ROUTES))
def test_narrow_pull_routes_give_the_spectrum(name):
    eng, keys, counts, spec, said = route_case(name, CPU)
    lo, hi, c = eng._pull_planes(spec, len(keys))
    assert said in eng.pulls[-1]
    assert np.array_equal(lo, keys.view(np.uint64)) and not hi.any()
    assert np.array_equal(c, counts) and c.dtype == np.int64


def reads(n: int, length: int, seed: int) -> list[Read]:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 40 * n)
    starts = rng.integers(0, len(genome) - length, n)
    return [Read(str(i), ACGT[genome[p:p + length]].tobytes())
            for i, p in enumerate(starts)]


def as_text(lo, hi, rho: int) -> list[str]:
    out = []
    for a, b in zip(lo.tolist(), hi.tolist()):
        v = (int(b) << 64) | int(a)
        out.append("".join("ACGT"[(v >> (2 * (rho - 1 - i))) & 3]
                           for i in range(rho)))
    return out


def count_edges(rs: list[Read], rho: int) -> dict:
    """Each rho-mer of the reads, and its reverse complement, once for
    each window it stands in."""
    comp = str.maketrans("ACGT", "TGCA")
    out: dict = {}
    for r in rs:
        s = r.seq.decode()
        for i in range(len(s) - rho + 1):
            w = s[i:i + rho]
            out[w] = out.get(w, 0) + 1
            rcw = w.translate(comp)[::-1]
            out[rcw] = out.get(rcw, 0) + 1
    return out


def finish(kind: str, device, rs: list[Read]):
    """A narrow (rho 26) or wide (rho 56) count of ``rs`` that spills,
    expanded (the narrow one's merge and expansion on ``device``) -> (lo,
    hi, counts)."""
    if kind == "narrow":
        rho, chunk = 26, 2048
        eng = E.SpectrumEngine(rho, "value", chunk, device, batch=2, cap=1 << 17)
    else:
        rho, chunk = 56, 1024
        eng = EW.SpectrumEngineWide(rho, "value", chunk, device, batch=4,
                                    cap=1 << 14)
    for codes in flat_code_chunks(rs, rho, chunk=chunk):
        eng.add_chunk(codes)
    out = eng.finish_expanded()
    assert eng.spills > 0
    assert kind == "wide" or eng.finish_log[-1].endswith(f"on {device}")
    return rho, out


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_cpu_finish_gives_the_edges_and_no_pinned_bytes(kind):
    rs = reads(400, 150, 7)
    rho, (lo, hi, c) = finish(kind, CPU, rs)
    want = count_edges(rs, rho)
    # every pull counted once: the spills' and the expansion's
    t = counters()
    assert t["#d2h_bytes"] >= lo.nbytes + c.nbytes and "#d2h_pinned_bytes" not in t
    # the sum of counts over the two strands' windows: a palindrome twice
    assert dict(zip(as_text(lo, hi, rho), c.tolist())) == want


# ----------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pull_lands_in_pinned_memory(cuda_device, dtype):
    t = sample(dtype, (1 << 20,)).to(cuda_device)
    got = T.to_host(t)
    assert base_tensor(got).is_pinned()
    assert got.dtype == t.cpu().numpy().dtype
    assert np.array_equal(got, t.cpu().numpy())
    assert counters() == {"#d2h_bytes": t.nbytes, "#d2h_pinned_bytes": t.nbytes}


@pytest.mark.cuda
def test_pull_is_a_copy_of_its_moment(cuda_device):
    t = torch.arange(1 << 22, dtype=torch.int64, device=cuda_device)
    got = T.to_host(t)
    t.mul_(3)  # queued after the pull
    torch.cuda.synchronize()
    assert np.array_equal(got, np.arange(1 << 22))


@pytest.mark.cuda
def test_two_pulls_kept_alive_do_not_alias(cuda_device):
    a = torch.full((1 << 22,), 1, dtype=torch.int64, device=cuda_device)
    b = torch.full((1 << 22,), 2, dtype=torch.int64, device=cuda_device)
    ha = T.to_host(a)
    hb = T.to_host(b)
    assert not np.shares_memory(ha, hb)
    assert (ha == 1).all() and (hb == 2).all()
    del hb
    hc = T.to_host(a * 5)  # may take hb's block again, never ha's
    assert not np.shares_memory(ha, hc)
    assert (ha == 1).all() and (hc == 5).all()


@pytest.mark.cuda
def test_run_pull_equals_per_plane_copies(cuda_device):
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(np.sort(rng.integers(0, 1 << 52, 1 << 20))).to(cuda_device)
    counts = torch.from_numpy(rng.integers(1, 1 << 40, 1 << 20)).to(cuda_device)
    lo, c = T.run_to_host(keys, counts)
    assert np.array_equal(lo, keys.cpu().numpy().view(np.uint64))
    assert np.array_equal(c, counts.cpu().numpy())
    assert base_tensor(lo).is_pinned() and base_tensor(c).is_pinned()
    assert base_tensor(lo).untyped_storage().data_ptr() == \
        base_tensor(c).untyped_storage().data_ptr()  # one block, carved


@pytest.mark.cuda
def test_wide_pull_equals_per_plane_copies(cuda_device):
    rng = np.random.default_rng(12)
    n, cap = 300_000, 300_011
    lo_u = rng.integers(0, 1 << 63, n, dtype=np.int64).view(np.uint64) * np.uint64(2)
    hi_u = rng.integers(0, 1 << 48, n, dtype=np.int64).view(np.uint64)
    hi, lo = EW.lanes_from_u64(lo_u, hi_u, cuda_device)
    c = torch.from_numpy(rng.integers(1, 1 << 40, n)).to(cuda_device)
    pad = cap - n
    spec = (torch.cat([hi, torch.full((pad,), EW.SENT, device=cuda_device)]),
            torch.cat([lo, torch.full((pad,), EW.SENT, device=cuda_device)]),
            torch.cat([c, torch.zeros(pad, dtype=torch.int64, device=cuda_device)]))
    eng = EW.SpectrumEngineWide(56, "value", 1024, cuda_device)
    got = eng._pull(spec, n)
    want = ((lo ^ EW.TOP).cpu().numpy().view(np.uint64),
            hi.cpu().numpy().view(np.uint64), c.cpu().numpy())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert base_tensor(g).is_pinned()
    assert np.array_equal(got[0], lo_u) and np.array_equal(got[1], hi_u)
    assert counters()["#d2h_pinned_bytes"] == 24 * n


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROUTES))
def test_narrow_pull_routes_equal_the_cpus(cuda_device, name):
    eng, keys, _counts, spec, said = route_case(name, cuda_device)
    got = eng._pull_planes(spec, len(keys))
    assert said in eng.pulls[-1]
    ceng, _k, _c, cspec, _s = route_case(name, CPU)
    for g, w in zip(got, ceng._pull_planes(cspec, len(keys))):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_finish_pulls_only_pinned_bytes(cuda_device, kind):
    rs = reads(400, 150, 7)
    _rho, got = finish(kind, cuda_device, rs)
    t = counters()
    assert t["#d2h_pinned_bytes"] == t["#d2h_bytes"] > 0
    profile.reset()
    _rho, want = finish(kind, CPU, rs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
