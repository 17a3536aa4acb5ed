"""Spectrum and classifier state between the JAX package and the port.

The JAX engine keeps a narrow spectrum as three uint32 planes (key high
and low words, count) with the sentinel pair ``(SENT32, SENT32)``; the
port keeps one int64 key per lane with the sentinel ``2**63 - 1`` and
int64 counts in [0, 2^32).  The JAX classifier holds its annotated set
as a uint64 E plane or as (high, low) uint32 planes; the port as one
int64 E tensor.

Wide keys (rho > 31): the JAX engine keeps five uint32 planes ``(p3, p2,
p1, p0, c)`` with the sentinel all ``SENT32``; the port keeps the two-lane
layout of :mod:`.ops.engine_wide` (``hi``, and ``lo`` with its top bit
flipped, sentinel ``(2^63 - 1, 2^63 - 1)``).  The JAX wide classifier holds
E as four uint32 planes, the port as the same two lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import profile

SENT32 = 0xFFFFFFFF
SENT64 = (1 << 63) - 1


def spectrum_from_planes(l1: np.ndarray, l0: np.ndarray, c: np.ndarray,
                         device: torch.device):
    """uint32 planes (numpy) -> ``(keys int64, counts int64)`` on ``device``."""
    l1 = np.asarray(l1, np.uint32)
    l0 = np.asarray(l0, np.uint32)
    sent = (l1 == SENT32) & (l0 == SENT32)
    keys = (l1.astype(np.int64) << 32) | l0.astype(np.int64)
    keys = np.where(sent, np.int64(SENT64), keys)
    counts = np.asarray(c, np.uint32).astype(np.int64)
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(counts).to(device))


def planes_from_spectrum(keys: torch.Tensor, counts: torch.Tensor):
    """``(keys int64, counts int64)`` -> uint32 planes (numpy) ``(l1, l0, c)``."""
    k = keys.cpu().numpy()
    sent = k == SENT64
    l1 = np.where(sent, SENT32, k >> 32).astype(np.uint32)
    l0 = np.where(sent, SENT32, k & 0xFFFFFFFF).astype(np.uint32)
    c = counts.cpu().numpy().astype(np.uint32)
    return l1, l0, c


def set_from_u64(set_E: np.ndarray, device: torch.device) -> torch.Tensor:
    """The JAX classifier's uint64 E plane (``classify.device.encode_set``)
    -> the port's int64 E tensor on ``device``.  Narrow E values (k <= 30)
    are below 2^62, so the bits are kept as they are."""
    set_E = np.ascontiguousarray(set_E, dtype=np.uint64)
    if len(set_E) and int(set_E.max()) >> 63:
        raise ValueError("set E values must be below 2^63 (narrow keys)")
    profile.count("h2d_bytes", set_E.nbytes)
    return torch.from_numpy(set_E.view(np.int64)).to(device)


def set_to_u64(set_E: torch.Tensor) -> np.ndarray:
    """The port's int64 E tensor -> the JAX uint64 E plane."""
    return set_E.cpu().numpy().view(np.uint64)


def set_from_planes(eh: np.ndarray, el: np.ndarray,
                    device: torch.device) -> torch.Tensor:
    """The JAX classifier's (set_eh, set_el) uint32 planes -> the port's
    int64 E tensor on ``device``."""
    e = ((np.asarray(eh, np.uint32).astype(np.uint64) << np.uint64(32))
         | np.asarray(el, np.uint32).astype(np.uint64))
    return set_from_u64(e, device)


def planes_from_set(set_E: torch.Tensor):
    """The port's int64 E tensor -> the JAX (set_eh, set_el) uint32 planes."""
    e = set_to_u64(set_E)
    return (e >> np.uint64(32)).astype(np.uint32), e.astype(np.uint32)


# ------------------------------------------------------------------ wide keys
def _u64(high: np.ndarray, low: np.ndarray) -> np.ndarray:
    return ((np.asarray(high, np.uint32).astype(np.uint64) << np.uint64(32))
            | np.asarray(low, np.uint32).astype(np.uint64))


def _lanes_from_limbs(p3, p2, p1, p0, device: torch.device):
    """Four uint32 planes -> (hi, lo) lanes; the all-``SENT32`` lane becomes
    the port's sentinel."""
    from .ops.engine_wide import lanes_from_u64

    hi, lo = _u64(p3, p2), _u64(p1, p0)
    sent = (hi == np.uint64(2**64 - 1)) & (lo == np.uint64(2**64 - 1))
    hi = np.where(sent, np.uint64(SENT64), hi)
    return lanes_from_u64(lo, hi, device)


def _limbs_from_lanes(hi: torch.Tensor, lo: torch.Tensor):
    from .ops.engine_wide import u64_from_lanes

    lo_u, hi_u = u64_from_lanes(hi, lo)
    sent = (hi_u == np.uint64(SENT64)) & (lo_u == np.uint64(2**64 - 1))
    hi_u = np.where(sent, np.uint64(2**64 - 1), hi_u)
    return ((hi_u >> np.uint64(32)).astype(np.uint32), hi_u.astype(np.uint32),
            (lo_u >> np.uint64(32)).astype(np.uint32), lo_u.astype(np.uint32))


def wide_spectrum_from_planes(p3, p2, p1, p0, c, device: torch.device):
    """The JAX wide engine's five uint32 planes (numpy) -> ``(hi, lo,
    counts)`` int64 lanes on ``device``."""
    counts = np.asarray(c, np.uint32).astype(np.int64)
    return (*_lanes_from_limbs(p3, p2, p1, p0, device),
            torch.from_numpy(counts).to(device))


def planes_from_wide_spectrum(hi: torch.Tensor, lo: torch.Tensor,
                              counts: torch.Tensor):
    """``(hi, lo, counts)`` lanes -> the JAX wide engine's five uint32
    planes (numpy) ``(p3, p2, p1, p0, c)``."""
    return (*_limbs_from_lanes(hi, lo),
            counts.cpu().numpy().astype(np.uint32))


def wide_set_from_u64(e_hi: np.ndarray, e_lo: np.ndarray,
                      device: torch.device):
    """``classify.device.encode_set_wide``'s numpy uint64 planes -> the
    port's ``(hi, lo)`` E lanes on ``device``."""
    from .ops.engine_wide import lanes_from_u64

    return lanes_from_u64(e_lo, e_hi, device)


def wide_set_from_planes(s3, s2, s1, s0, device: torch.device):
    """The JAX ``encode_set_wide``'s four uint32 planes -> the port's
    ``(hi, lo)`` E lanes on ``device``."""
    return wide_set_from_u64(_u64(s3, s2), _u64(s1, s0), device)


def planes_from_wide_set(hi: torch.Tensor, lo: torch.Tensor):
    """The port's ``(hi, lo)`` E lanes -> the JAX four uint32 planes."""
    return _limbs_from_lanes(hi, lo)
