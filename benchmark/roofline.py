"""The bound model of the kernels' roofline shares.

Frozen copy of ``PEAK_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``bound``,
``fold_bound`` and ``merge_bound`` of ``chip_smoke.py`` at commit 04cc210
(the model of PERF.md section 6 there: inputs read once, outputs written
once, at the published 3.35 TB/s of one H100 SXM).  Times are in seconds
here.  The work is counted from an entry's arguments, so it stays the same
whatever later implements the entry.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# 3.35 TB/s; 67 TFLOP/s outside the tensor cores, taken for the kernels'
# compare-and-add arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def fold_bound_s(na: int, nb: int, cap: int) -> float:
    """merge_fold reads 16 B a lane of A and B and writes 16 B a lane of
    the ``cap`` output lanes and ``live``; one comparison and one addition
    a merged lane."""
    return bound_s((na + nb + cap) * 16 + 8, 2 * (na + nb))


def merge_bound_s(na: int, nb: int) -> float:
    """merge_sorted reads and writes 16 B a lane; one comparison a lane."""
    return bound_s(2 * (na + nb) * 16, na + nb)
