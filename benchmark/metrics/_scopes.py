"""Reductions over the program's profile, ``records["calls"][i]["profile"]``
(``gossamer_tpu_torch.utils.profile.totals()``): scope paths summed by
their last labels, so that nesting does not matter, and counters read by
their ``#`` key.  A program without the scope or the counter (one older
than it) gives None."""

from __future__ import annotations

from benchmark.metrics._shared import mean_over_calls

COUNTER = "#"


def _ends_with(path: str, labels) -> bool:
    return not path.startswith(COUNTER) and any(
        path == lab or path.endswith("/" + lab) for lab in labels)


def scope_s(records: dict, *labels: str) -> float | None:
    """Seconds a call spends in every scope path that ends in one of
    ``labels`` (each one or more whole labels, ``graph/write/hist``), mean
    over the calls; None where no call entered one."""
    if not any(_ends_with(p, labels) for c in records["calls"]
               for p in c.get("profile", {})):
        return None
    return mean_over_calls(records, lambda c: sum(
        v for p, v in c["profile"].items() if _ends_with(p, labels)))


def counter(records: dict, name: str) -> float | None:
    """The counter ``#<name>`` of a call, mean over the calls; None where
    no call counted it."""
    key = COUNTER + name
    if not any(key in c.get("profile", {}) for c in records["calls"]):
        return None
    return mean_over_calls(records, lambda c: c["profile"].get(key, 0.0))
