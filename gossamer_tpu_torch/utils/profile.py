"""Hierarchical wall-clock profiler (reference ``src/Profile.hh:55-199``).

The reference's ``Profile::Context`` scopes are compile-time gated; here
profiling is enabled with ``GOSSAMER_TPU_PROFILE=1`` (or
``profile.enable()``) and reported per call path.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict

_ENABLED = os.environ.get("GOSSAMER_TPU_PROFILE", "") not in ("", "0")
_STACK: list[str] = []
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


class context:
    """``with profile.context("label"):`` — times the enclosed block."""

    def __init__(self, label: str):
        self.label = label
        self.t0 = 0.0

    def __enter__(self):
        if _ENABLED:
            _STACK.append(self.label)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _ENABLED:
            path = "/".join(_STACK)
            _TOTALS[path] += time.perf_counter() - self.t0
            _COUNTS[path] += 1
            _STACK.pop()
        return False


def report(out=None) -> None:
    import sys

    out = out or sys.stderr
    for path in sorted(_TOTALS, key=lambda p: -_TOTALS[p]):
        out.write(f"{_TOTALS[path]:10.3f}s  {_COUNTS[path]:8d}x  {path}\n")


def totals() -> dict[str, float]:
    """Seconds per call path so far."""
    return dict(_TOTALS)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()
