"""Merge-fold of the PyTorch port against the JAX package.

The port's plain fold (``merge_fold`` on CPU tensors) must equal, exactly,
the JAX interpret-mode Pallas kernel ``merge_fold_planes`` and the XLA
sort path ``_sort_count_compact`` on the same inputs, made from a seed
with numpy and carried across with ``convert.spectrum_from_planes``.
The CUDA kernel is held against the plain version on the card only; the
edge cases the card run uses (``chip_smoke.fold_edge_cases``) go through
the plain version against the interpret-mode Pallas kernel here, so the
oracle of the card run is itself held to the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

from gossamer_tpu.ops.engine import _sort_count_compact
from gossamer_tpu.ops.pallas_fold import merge_fold_planes
from gossamer_tpu.ops.pallas_merge import SENT32, TILE
from gossamer_tpu_torch.convert import planes_from_spectrum, spectrum_from_planes
from gossamer_tpu_torch.ops.fold import SENT, merge_fold, merge_fold_reference

CPU = torch.device("cpu")
# the CUDA kernel's default tile in merged lanes (csrc/fold.cu: 128 threads
# x 27 lanes); the card cases put their group and order faults on its edges
CARD_TILE = 128 * 27
CARD_CASES, CARD_UNSORTED = chip_smoke.fold_edge_cases(CPU, CARD_TILE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    return torch.device("cuda")


def planes(keys: np.ndarray, counts: np.ndarray, total: int):
    """Ascending int keys + counts -> sentinel-padded uint32 planes."""
    l1 = np.full(total, SENT32, np.uint32)
    l0 = np.full(total, SENT32, np.uint32)
    c = np.zeros(total, np.uint32)
    n = len(keys)
    l1[:n] = (keys >> 32).astype(np.uint32)
    l0[:n] = (keys & 0xFFFFFFFF).astype(np.uint32)
    c[:n] = counts
    return l1, l0, c


def mk_run(rng, n_real, total, key_space=1 << 52, dup=False, spectrum=False):
    keys = rng.integers(0, key_space, size=n_real, dtype=np.int64)
    if dup and n_real:
        keys = keys[rng.integers(0, max(1, n_real // 7), size=n_real)]
    keys = np.unique(keys) if spectrum else np.sort(keys)
    counts = (rng.integers(1, 1 << 32, len(keys), dtype=np.int64) if spectrum
              else np.ones(len(keys), np.int64))
    return planes(keys, counts, total)


def port_fold(a, b, cap, fn=merge_fold, device=CPU):
    ak, ac = spectrum_from_planes(*a, device)
    bk, bc = spectrum_from_planes(*b, device)
    keys, counts, live = fn(ak, ac, bk, bc, cap)
    return keys.cpu().numpy(), counts.cpu().numpy(), int(live)


def as_keys(l1, l0):
    k = (np.asarray(l1).astype(np.int64) << 32) | np.asarray(l0).astype(np.int64)
    sent = (np.asarray(l1) == SENT32) & (np.asarray(l0) == SENT32)
    return np.where(sent, SENT, k)


@pytest.mark.parametrize("na,nb,dup", [(TILE, TILE, False), (3000, 5000, True)])
def test_plain_fold_matches_pallas_interpret(na, nb, dup):
    rng = np.random.default_rng(7)
    a = mk_run(rng, na, TILE, dup=dup, spectrum=True)
    b = mk_run(rng, nb, TILE, dup=dup)
    o1, o0, oc, live = merge_fold_planes(*a, *b, True)
    live = int(live)
    keys, counts, plive = port_fold(a, b, 2 * TILE)
    assert plive == live
    assert np.array_equal(keys[:live], as_keys(o1, o0)[:live])
    assert np.array_equal(counts[:live], np.asarray(oc)[:live].astype(np.int64))
    assert (keys[live:] == SENT).all() and (counts[live:] == 0).all()


def edge_cases():
    """(name, A planes, B planes, cap) for the fold's edge cases."""
    rng = np.random.default_rng(11)
    cases = []
    # a group of equal batch keys spanning many kernel tiles (2048 lanes)
    a = mk_run(rng, 4000, 4096, key_space=1 << 20, spectrum=True)
    bk = np.full(9000, 777, np.int64)
    cases.append(("span", a, planes(bk, np.ones(9000, np.int64), 10000), 12000))
    # one key across everything: its count wraps mod 2^32
    ak = np.full(6000, 42, np.int64)
    cases.append(("wrap", planes(ak, np.full(6000, 1 << 20, np.int64), 6000),
                  planes(np.full(5000, 42, np.int64), np.ones(5000, np.int64),
                         5000), 64))
    # an empty batch
    cases.append(("empty batch", mk_run(rng, 3000, 4096, spectrum=True),
                  planes(np.zeros(0, np.int64), np.zeros(0, np.int64), 512),
                  4096))
    # a spectrum at exactly cap, batch keys all already present
    sk = np.unique(rng.integers(0, 1 << 50, 3000))
    sc = rng.integers(1, 1000, len(sk))
    bk = np.sort(sk[rng.integers(0, len(sk), 2000)])
    cases.append(("at cap", planes(sk, sc, len(sk)),
                  planes(bk, np.ones(len(bk), np.int64), len(bk)), len(sk)))
    # new batch keys push live past cap (no sentinel lanes: JAX counts a
    # cropped sentinel group in its live)
    nk = np.sort(rng.integers(0, 1 << 50, 2000))
    cases.append(("live > cap", planes(sk, sc, len(sk)),
                  planes(nk, np.ones(len(nk), np.int64), len(nk)), len(sk)))
    return cases


@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_plain_fold_matches_sort_count_compact(case):
    _name, a, b, cap = case
    k1, k0, c, live = _sort_count_compact(
        np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]),
        np.concatenate([a[2], b[2]]), cap)
    keys, counts, plive = port_fold(a, b, cap)
    assert plive == int(live)
    assert np.array_equal(keys, as_keys(k1, k0))
    assert np.array_equal(counts, np.asarray(c).astype(np.int64))


def test_fold_flags_unsorted_input():
    keys = torch.tensor([5, 3, SENT])
    counts = torch.tensor([1, 1, 0])
    empty = torch.zeros(0, dtype=torch.int64)
    _k, _c, live = merge_fold(keys, counts, empty, empty, 4)
    assert int(live) == -1


@pytest.mark.parametrize("name", list(CARD_UNSORTED))
def test_fold_flags_input_out_of_order_in_one_run(name):
    a, ac, b, bc, cap = CARD_UNSORTED[name]
    assert int(merge_fold(a, ac, b, bc, cap)[2]) == -1
    # each run on its own: only the one named is at fault
    asc = [bool((k[1:] >= k[:-1]).all()) for k in (a, b)]
    assert asc == [name.startswith("only B"), name.startswith("only A")]


def padded_planes(keys: torch.Tensor, counts: torch.Tensor):
    """int64 run -> uint32 planes padded with sentinels to the Pallas
    kernel's lengths (a nonzero multiple of its TILE)."""
    l1, l0, c = planes_from_spectrum(keys, counts)
    total = max(1, -(-len(l1) // TILE)) * TILE
    out = planes(np.zeros(0, np.int64), np.zeros(0, np.int64), total)
    for dst, src in zip(out, (l1, l0, c)):
        dst[: len(src)] = src
    return out


@pytest.mark.parametrize("name", list(CARD_CASES))
def test_plain_fold_matches_pallas_interpret_on_card_cases(name):
    a, ac, b, bc, cap = CARD_CASES[name]
    o1, o0, oc, live = merge_fold_planes(*padded_planes(a, ac),
                                         *padded_planes(b, bc), True)
    live = int(live)
    keys, counts, plive = merge_fold_reference(a, ac, b, bc, cap)
    assert int(plive) == live
    kept = min(live, cap)
    assert np.array_equal(keys.numpy()[:kept], as_keys(o1, o0)[:kept])
    assert np.array_equal(counts.numpy()[:kept],
                          np.asarray(oc)[:kept].astype(np.int64))
    assert (keys[kept:] == SENT).all() and (counts[kept:] == 0).all()


def test_fold_rejects_bad_dtype():
    k = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        merge_fold(k, k, k, k, 4)


def test_convert_round_trip():
    rng = np.random.default_rng(3)
    l1, l0, c = mk_run(rng, 1000, 1500, key_space=1 << 62, spectrum=True)
    keys, counts = spectrum_from_planes(l1, l0, c, CPU)
    assert keys.dtype == torch.int64 and counts.dtype == torch.int64
    assert (keys[1000:] == SENT).all() and (keys[:1000] < (1 << 62)).all()
    for got, want in zip(planes_from_spectrum(keys, counts), (l1, l0, c)):
        assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain_on_card(case, cuda_device):
    _name, a, b, cap = case
    got = port_fold(a, b, cap, merge_fold, cuda_device)
    want = port_fold(a, b, cap, merge_fold_reference, cuda_device)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_plain_on_card_cases(name, cuda_device):
    a, ac, b, bc, cap = chip_smoke.fold_edge_cases(cuda_device, CARD_TILE)[0][name]
    got = merge_fold(a, ac, b, bc, cap)
    want = merge_fold_reference(a, ac, b, bc, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_UNSORTED))
def test_kernel_flags_input_out_of_order_on_card(name, cuda_device):
    a, ac, b, bc, cap = chip_smoke.fold_edge_cases(cuda_device, CARD_TILE)[1][name]
    assert int(merge_fold(a, ac, b, bc, cap)[2]) == -1
