"""Reductions the end-to-end metric files share."""

from __future__ import annotations


def per_second(window: dict, quantity: str) -> float | None:
    """All the work of the window's calls over all their time: the sum of
    ``quantity`` over the sum of the calls' walls."""
    calls = window["calls"]
    walls = sum(c["wall_s"] for c in calls)
    if not calls or walls <= 0:
        return None
    return sum(c["work"][quantity] for c in calls) / walls
