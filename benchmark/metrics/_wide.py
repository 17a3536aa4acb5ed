"""The bound of one wide batch step (``ops.engine_wide.batch_step_wide``),
from its arguments, under kernel B2's convention (``roofline.fold_bound_s``):
the resident spectrum's lanes read once at 24 B a lane (``hi``, ``lo``,
count), the batch's codes read once at 1 B a code, the ``cap`` output lanes
written once at 24 B a lane; one comparison and one addition a merged lane.
The same bound holds whatever implements the step."""

from __future__ import annotations

from benchmark.roofline import bound_s

LANE_BYTES = 24  # hi, lo and count, int64 each


def flush_bytes(resident: int, codes: int, cap: int) -> int:
    return LANE_BYTES * (resident + cap) + codes


def flush_bound(codes, s_hi, s_lo, s_c, rho, mode, cap):
    """The least time of one ``batch_step_wide`` call."""
    windows = codes.shape[0] * (codes.shape[1] - int(rho) + 1)
    return bound_s(flush_bytes(s_hi.numel(), codes.numel(), int(cap)),
                   2 * (s_hi.numel() + windows))
