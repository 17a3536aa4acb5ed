"""Reductions the metric files share."""

from __future__ import annotations

import statistics

from benchmark.roofline import fold_bound_s, merge_bound_s

PORT_PROFILE = "gossamer_tpu_torch.utils.profile"


def mean_over_calls(records: dict, value) -> float | None:
    """Mean of ``value(call)`` over the traced calls; None when any call
    lacks what it reads."""
    vals = []
    for call in records["calls"]:
        try:
            vals.append(value(call))
        except KeyError:
            return None
    return sum(vals) / len(vals) if vals else None


def span_s(records: dict, name: str) -> float | None:
    """Host seconds a call spends in the benchmark's span ``name``; None
    where no call entered it."""
    if not any(name in c.get("spans", {}) for c in records["calls"]):
        return None
    return mean_over_calls(records, lambda c: c["spans"].get(name, 0.0))


def summed_s(records: dict, field: str, names) -> float | None:
    """Seconds a call spends in the program's ``names`` of one record
    ``field``: ``phases`` (the count's log line) or ``profile`` (scopes)."""
    return mean_over_calls(records, lambda c: sum(c[field][n] for n in names))


def roofline_pct(records: dict, kernel: str) -> float | None:
    """Sum of the calls' bounds over the sum of their device seconds, in %;
    None without device time (never a number from the CPU)."""
    calls = records["kernels"].get(kernel, [])
    device = sum(d for _, d in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device


def idle_pct(records: dict) -> float | None:
    dev = records.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def fold_bound(a_keys, a_counts, b_keys, b_counts, cap):
    """The least time of one ``merge_fold`` call, from its arguments."""
    return fold_bound_s(a_keys.numel(), b_keys.numel(), int(cap))


def merge_bound(a_keys, a_vals, b_keys, b_vals):
    """The least time of one ``merge_sorted`` call, from its arguments."""
    return merge_bound_s(a_keys.numel(), b_keys.numel())


def median_wall_s(records: dict) -> float | None:
    """The median call's wall over the traced calls: steadier than the
    rate, which one slow call moves."""
    walls = [c["wall_s"] for c in records["calls"]]
    return statistics.median(walls) if walls else None
