"""Merge of sorted runs in the PyTorch port against the JAX package.

The port's plain merge (``merge_sorted`` on CPU tensors, i.e.
``merge_sorted_reference``) must give the same keys, in order, as the
interpret-mode Pallas kernel ``merge_sorted_planes`` on the same runs, made
from a seed with numpy and carried across with
``convert.spectrum_from_planes``, and the same (key, count) multiset (the
JAX kernel may swap the payloads of equal keys).  The CUDA kernel is held
against the plain version on the card only, exactly.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from gossamer_tpu.ops.pallas_merge import SENT32, TILE, merge_sorted_planes
from gossamer_tpu_torch.convert import spectrum_from_planes
from gossamer_tpu_torch.ops.fold import SENT
from gossamer_tpu_torch.ops.merge import merge_sorted, merge_sorted_reference
from merge_cases import edge_cases

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    return torch.device("cuda")


def mk_run(rng, n_real, key_space=1 << 52):
    """A sentinel-padded run of TILE-multiple length as uint32 planes."""
    keys = np.sort(rng.integers(0, key_space, size=n_real, dtype=np.uint64))
    total = -(-n_real // TILE) * TILE
    l1 = np.full(total, SENT32, np.uint32)
    l0 = np.full(total, SENT32, np.uint32)
    c = np.zeros(total, np.uint32)
    l1[:n_real] = (keys >> np.uint64(32)).astype(np.uint32)
    l0[:n_real] = keys.astype(np.uint32)
    c[:n_real] = rng.integers(1, 100, n_real)
    return l1, l0, c


def as_keys(l1, l0):
    k = (np.asarray(l1).astype(np.int64) << 32) | np.asarray(l0).astype(np.int64)
    sent = (np.asarray(l1) == SENT32) & (np.asarray(l0) == SENT32)
    return np.where(sent, SENT, k)


@pytest.mark.parametrize("na,nb,key_space", [
    (TILE, TILE, 1 << 52),      # one tile each
    (3000, 2 * TILE, 1 << 52),  # two tiles in B
    (3000, 5000, 64),           # equal keys carrying distinct counts
])
def test_plain_merge_matches_pallas_interpret(na, nb, key_space):
    rng = np.random.default_rng(na + nb)
    a = mk_run(rng, na, key_space)
    b = mk_run(rng, nb, key_space)
    o1, o0, oc = merge_sorted_planes(*a, *b, True)
    want_keys = as_keys(o1, o0)
    keys, counts = merge_sorted(*spectrum_from_planes(*a, CPU),
                                *spectrum_from_planes(*b, CPU))
    keys, counts = keys.numpy(), counts.numpy()
    assert np.array_equal(keys, want_keys)
    assert Counter(zip(keys.tolist(), counts.tolist())) == Counter(
        zip(want_keys.tolist(), np.asarray(oc).astype(np.int64).tolist()))


def test_merge_is_stable_with_a_first():
    t = torch.tensor
    keys, vals = merge_sorted(t([1, 1, 2, SENT]), t([10, 11, 12, 0]),
                              t([1, 2]), t([20, 21]))
    assert keys.tolist() == [1, 1, 1, 2, 2, SENT]
    assert vals.tolist() == [10, 11, 20, 12, 21, 0]


def test_merge_rejects_bad_input():
    k = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        merge_sorted(k, k, k, k)
    a = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="differ in length"):
        merge_sorted(a, a[:1].clone(), a, a)


@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_plain_merge_equals_stable_sort(case):
    _name, ak, av, bk, bv = case
    keys, vals = merge_sorted_reference(*map(torch.from_numpy, (ak, av, bk, bv)))
    order = np.argsort(np.concatenate([ak, bk]), kind="stable")
    assert np.array_equal(keys.numpy(), np.concatenate([ak, bk])[order])
    assert np.array_equal(vals.numpy(), np.concatenate([av, bv])[order])


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain_on_card(case, cuda_device):
    _name, *arrays = case
    t = [torch.from_numpy(x).to(cuda_device) for x in arrays]
    got = merge_sorted(*t)
    want = merge_sorted_reference(*t)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
