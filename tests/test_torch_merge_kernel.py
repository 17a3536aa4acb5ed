"""The merge kernel's two passes in the PyTorch port (``ops/merge.py``).

On the CPU: the split pass's plain version (``merge_splits_reference``)
against a brute-force count, the merge rebuilt tile by tile from those
splits against ``merge_sorted_reference``, and the wrappers' checks.  On
the card (marker ``cuda``): both kernels (``merge_splits``,
``merge_tiles``) against their plain versions, exactly, on the kernel's
own edges: more tiles than resident blocks, one tile, one stage +- 1 lane,
views at an odd lane, one key over many tiles.  No JAX here: the JAX
parity of the plain merge is ``tests/test_torch_merge.py``.  On a machine
with a card and without JAX:
``python -m pytest tests/test_torch_merge_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu_torch.ops.merge import (merge_sorted, merge_sorted_reference,
                                          merge_splits, merge_splits_reference)
from merge_cases import brute_splits, card_cases, edge_cases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    return torch.device("cuda")


@pytest.mark.parametrize("tile", [1, 2, 7, 64, 1792])
@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_plain_splits_equal_a_brute_force_count(case, tile):
    _name, ak, _av, bk, _bv = case
    got = merge_splits_reference(torch.from_numpy(ak), torch.from_numpy(bk),
                                 tile)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), brute_splits(ak, bk, tile))


@pytest.mark.parametrize("tile", [3, 64, 1792])
@pytest.mark.parametrize("case", edge_cases(), ids=lambda c: c[0])
def test_tiles_merged_from_the_splits_join_to_the_merge(case, tile):
    """Tile t merges a[s_t:s_t+1] with B's lanes between the same
    diagonals; the tiles, joined, are the whole merge."""
    _name, *arrays = case
    ak, av, bk, bv = map(torch.from_numpy, arrays)
    n = ak.numel() + bk.numel()
    s = merge_splits(ak, bk, tile).tolist()
    keys, vals = [], []
    for t in range(len(s) - 1):
        d0, d1 = t * tile, min((t + 1) * tile, n)
        a0, a1, b0, b1 = s[t], s[t + 1], d0 - s[t], d1 - s[t + 1]
        assert a1 - a0 + b1 - b0 == d1 - d0
        k, v = merge_sorted_reference(ak[a0:a1], av[a0:a1], bk[b0:b1],
                                      bv[b0:b1])
        keys.append(k)
        vals.append(v)
    want = merge_sorted_reference(ak, av, bk, bv)
    got = (torch.cat(keys), torch.cat(vals)) if keys else want
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_splits_reject_bad_input():
    a = torch.tensor([1, 2, 3])
    b = torch.tensor([2, 4])
    with pytest.raises(ValueError, match="tile"):
        merge_splits(a, b, 0)
    with pytest.raises(ValueError, match="int64"):
        merge_splits(a.to(torch.int32), b, 2)
    with pytest.raises(ValueError, match="contiguous"):
        merge_splits(a, torch.tensor([1, 2, 3, 4])[::2], 2)
    with pytest.raises(ValueError, match="on meta"):
        merge_splits(a, b.to("meta"), 2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        merge_splits(a.to("meta"), b.to("meta"), 2)
    with pytest.raises(ValueError, match="on meta"):
        merge_sorted(a, a, b.to("meta"), b.to("meta"))


# ------------------------------------------------------------- on the card
def kernel_tile(dev):
    """(the default build's tile, the blocks the card holds at once)."""
    from gossamer_tpu_torch.ops import merge

    lib = merge._kernel_lib()
    return (lib.gossamer_merge_tile(),
            merge.blocks_per_sm(lib, dev)
            * torch.cuda.get_device_properties(dev).multi_processor_count)


def odd_offset(x):
    """The same lanes starting 8 bytes into a 16-byte piece (x[1:] of a
    fresh tensor)."""
    return torch.cat([x.new_zeros(1), x])[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True], ids=["aligned", "odd offset"])
def test_kernel_matches_plain_on_its_edges_on_card(shift, cuda_device):
    from gossamer_tpu_torch.ops import merge

    for name, *arrays in [*edge_cases(), *card_cases(*kernel_tile(cuda_device))]:
        t = [torch.from_numpy(np.asarray(x, np.int64)).to(cuda_device)
             for x in arrays]
        if shift:
            t = [odd_offset(x) for x in t]
            assert all(x.numel() == 0 or x.data_ptr() % 16 == 8 for x in t)
        before = merge.merge_sorted.launches, merge.merge_splits.launches
        got = merge_sorted(*t)
        want = merge_sorted_reference(*t)
        torch.cuda.synchronize()
        n = t[0].numel() + t[2].numel()
        assert (merge.merge_sorted.launches, merge.merge_splits.launches) == (
            before[0] + 1, before[1] + (n > 0)), name
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("group", [None, 1, 2, 32],
                         ids=["default build", "1 lane", "2 lanes", "32 lanes"])
@pytest.mark.parametrize("tile", [1, 7, 1792])
def test_split_kernel_matches_plain_on_card(tile, group, cuda_device):
    """The default build's split pass, and builds with other lanes a
    boundary (``-DMERGE_SPLIT_GROUP``), against the plain version."""
    from gossamer_tpu_torch.ops import merge

    lib = merge._kernel_lib(**({} if group is None
                               else {"MERGE_SPLIT_GROUP": group}))
    for name, ak, _av, bk, _bv in [*edge_cases(),
                                   *card_cases(*kernel_tile(cuda_device))]:
        a, b = (torch.from_numpy(np.asarray(x, np.int64)).to(cuda_device)
                for x in (ak, bk))
        got = merge_splits(a, b, tile, lib)
        want = merge_splits_reference(a, b, tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, lib.gossamer_merge_split_group())
