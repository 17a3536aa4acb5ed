"""Packed k-merization and canonicalization of the PyTorch port against
the JAX package: the same packed chunks (seeded numpy codes with Ns and
tail padding) go through ``kmerize_packed`` + ``_canon_mask_flat`` of
both, and the sorted key multisets must be equal.  rho = 31 reaches bit
61 of the keys, where an arithmetic shift on int64 would show.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.io.stream import pack_chunk as jax_pack_chunk
from gossamer_tpu.ops.engine import _canon_mask_flat, kmerize_packed, rc_planes
from gossamer_tpu_torch.io.stream import pack_chunk
from gossamer_tpu_torch.ops import canon
from gossamer_tpu_torch.ops import kmerize as tk
from gossamer_tpu_torch.ops.fold import SENT

SENT32 = 0xFFFFFFFF


def random_codes(rng, rho: int, C: int, n_valid: int) -> np.ndarray:
    """C + rho - 1 codes: bases with Ns and read separators, then a
    padded tail of 255 after ``n_valid`` codes."""
    codes = rng.integers(0, 4, C + rho - 1).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.01] = 255  # N / separator
    codes[n_valid:] = 255
    return codes


def jax_keys(words, inval, rho, C, mode):
    l1, l0, valid = kmerize_packed(words, inval, rho, C)
    l1, l0, _ = _canon_mask_flat(l1, l0, valid, rho, mode)
    l1, l0 = np.asarray(l1), np.asarray(l0)
    k = (l1.astype(np.int64) << 32) | l0.astype(np.int64)
    return np.sort(np.where((l1 == SENT32) & (l0 == SENT32), SENT, k))


def port_keys(words, inval, rho, C, mode):
    keys, valid = tk.kmerize_packed(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(inval), rho, C)
    keys = canon.canonicalize(keys.reshape(-1), rho, mode)
    keys = torch.where(valid.reshape(-1), keys, SENT)
    return np.sort(keys.numpy())


@pytest.mark.parametrize("rho", [12, 26, 31])
@pytest.mark.parametrize("mode", ["value", "plain"])
def test_kmerize_canon_matches_jax(rho, mode):
    rng = np.random.default_rng(rho)
    C = 2048
    chunks = [random_codes(rng, rho, C, n) for n in (C + rho - 1, C // 3)]
    words = np.stack([pack_chunk(c, rho, C)[0] for c in chunks])
    inval = np.stack([pack_chunk(c, rho, C)[1] for c in chunks])
    for c in chunks:  # the copied packer gives the JAX packer's bytes
        for got, want in zip(pack_chunk(c, rho, C), jax_pack_chunk(c, rho, C)):
            assert np.array_equal(got, want)
    got = port_keys(words, inval, rho, C, mode)
    want = jax_keys(words, inval, rho, C, mode)
    assert np.array_equal(got, want)
    assert (got != SENT).sum() > C // 2  # windows really were valid
    assert (got[got != SENT] < (1 << (2 * rho))).all()


@pytest.mark.parametrize("rho", [12, 26, 31])
def test_rc_matches_rc_planes(rho):
    rng = np.random.default_rng(100 + rho)
    keys = rng.integers(0, 1 << (2 * rho), 5000, dtype=np.int64)
    keys[:3] = [0, (1 << (2 * rho)) - 1, 1 << (2 * rho - 1)]
    r1, r0 = rc_planes((keys >> 32).astype(np.uint32),
                       (keys & 0xFFFFFFFF).astype(np.uint32), rho)
    want = (np.asarray(r1).astype(np.int64) << 32) | np.asarray(r0).astype(np.int64)
    got = canon.rc(torch.from_numpy(keys), rho).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(canon.rc(torch.from_numpy(got), rho).numpy(), keys)


def test_window_order_is_natural():
    """Port windows come out in stream order (the JAX side phase-major)."""
    rho, C = 5, 32
    codes = np.arange(C + rho - 1, dtype=np.uint8) % 4
    words, inval = pack_chunk(codes, rho, C)
    keys, valid = tk.kmerize_packed(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(inval), rho, C)
    want = [int("".join(str(b) for b in codes[p : p + rho]), 4) for p in range(C)]
    assert keys.tolist() == want and bool(valid.all())


def test_canon_ref_not_ported():
    """Mode "ref" is ported now (tests/test_torch_kmer_set.py holds it
    against JAX): it is the FNV order; a mode that does not exist raises."""
    keys = torch.tensor([0, 5, (1 << 24) - 1, 123456])
    assert torch.equal(canon.canonicalize(keys, 12, "ref"),
                       canon.canon_ref(keys, 12))
    with pytest.raises(ValueError, match="not in"):
        canon.canonicalize(keys, 12, "fnv")
