"""The two-lane k-mer functions of ``ops/device_kmer.py`` (``rev2``,
``reverse_complement``, ``fnv_hash``, ``less128``) against the JAX ones on
the same seeded ``(lo, hi)`` uint64 keys at k = 5, 31, 32 and 62, bit for
bit; the port holds each uint64 lane as the int64 of the same bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gossamer_tpu.ops import device_kmer as J
from gossamer_tpu_torch.ops import device_kmer as D


def _keys(k: int, n: int, seed: int):
    """``n`` random 2k-bit keys as (lo, hi) uint64, with the all-A and
    all-T keys."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    top = (1 << (2 * k)) - 1
    lo &= np.uint64(top & ((1 << 64) - 1))
    hi &= np.uint64(top >> 64)
    lo[:2] = (0, top & ((1 << 64) - 1))
    hi[:2] = (0, top >> 64)
    return lo, hi


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _u64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint64)
    return np.asarray(x, np.uint64)


@pytest.mark.parametrize("k", [5, 31, 32, 62])
def test_two_lane_functions_match_jax(k):
    lo, hi = _keys(k, 2000, seed=k)
    jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
    assert np.array_equal(_u64(D.rev2(_t(lo))), _u64(J.rev2(jlo)))
    rlo, rhi = D.reverse_complement(_t(lo), _t(hi), k)
    wlo, whi = J.reverse_complement(jlo, jhi, k)
    assert np.array_equal(_u64(rlo), _u64(wlo))
    assert np.array_equal(_u64(rhi), _u64(whi))
    r2 = D.reverse_complement(rlo, rhi, k)
    assert torch.equal(r2[0], _t(lo)) and torch.equal(r2[1], _t(hi))
    assert np.array_equal(_u64(D.fnv_hash(_t(lo), _t(hi))),
                          _u64(J.fnv_hash(jlo, jhi)))
    assert np.array_equal(
        D.less128(_t(lo), _t(hi), rlo, rhi).numpy(),
        np.asarray(J.less128(jlo, jhi, wlo, whi)))


def test_less128_is_unsigned():
    """Bit 63 of either word set: the order of the unsigned values."""
    lo = np.array([1 << 63, 0, 5, 1 << 63], np.uint64)
    hi = np.array([0, 1 << 63, 1 << 63, 1 << 63], np.uint64)
    got = D.less128(_t(lo[:, None].repeat(4, 1).ravel()),
                    _t(hi[:, None].repeat(4, 1).ravel()),
                    _t(np.tile(lo, 4)), _t(np.tile(hi, 4))).numpy()
    vals = [int(h) << 64 | int(x) for x, h in zip(lo, hi)]
    want = [a < b for a in vals for b in vals]
    assert got.tolist() == want
    assert got.tolist() == np.asarray(J.less128(
        jnp.asarray(lo[:, None].repeat(4, 1).ravel()),
        jnp.asarray(hi[:, None].repeat(4, 1).ravel()),
        jnp.asarray(np.tile(lo, 4)), jnp.asarray(np.tile(hi, 4)))).tolist()
