"""Spectrum state between the JAX package and the port.

The JAX engine keeps a narrow spectrum as three uint32 planes (key high
and low words, count) with the sentinel pair ``(SENT32, SENT32)``; the
port keeps one int64 key per lane with the sentinel ``2**63 - 1`` and
int64 counts in [0, 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

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
