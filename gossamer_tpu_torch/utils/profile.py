"""Hierarchical wall-clock profiler (reference ``src/Profile.hh:55-199``).

The reference's ``Profile::Context`` scopes are compile-time gated; here
profiling is switched on by ``-D print-profile`` (any CLI) or
:func:`enable` and reported per call path: ``with profile.context("a"):``
inside ``with profile.context("b"):`` is path ``b/a``.

While profiling is on, each scope is also a ``torch.profiler.record_function``
range named by its path, so a ``torch.profiler`` trace holds the program's
scopes on the same clock as the device's kernels and copies (and ``nsys``
under ``torch.autograd.profiler.emit_nvtx`` shows them as NVTX ranges).
Counters (:func:`count`) live in the same :func:`totals` mapping under keys
that begin with ``#``, which no scope path does: among them the copies'
bytes, ``#h2d_bytes`` and ``#d2h_bytes``, and ``#d2h_pinned_bytes``, the
part of ``#d2h_bytes`` that landed in page-locked memory.  Per-item timing
(:func:`iterate`) adds seconds to a path but opens no range.
While profiling is off, a scope costs one flag check and records nothing.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

COUNTER = "#"  # the first character of a counter's key in totals()

_ENABLED = False
_STACK: list[str] = []
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


class context:
    """``with profile.context("label"):`` times the enclosed block.

    ``clock=True`` reads the clock while profiling is off too, for a caller
    that keeps the block's seconds itself (:attr:`seconds`): one reading
    serves both."""

    __slots__ = ("label", "clock", "t0", "seconds", "_range")

    def __init__(self, label: str, clock: bool = False):
        self.label = label
        self.clock = clock
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _ENABLED:
            _STACK.append(self.label)
            self._range = torch.profiler.record_function("/".join(_STACK))
            self._range.__enter__()
            self.t0 = time.perf_counter()
        elif self.clock:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self.seconds = time.perf_counter() - self.t0
            path = "/".join(_STACK)
            _TOTALS[path] += self.seconds
            _COUNTS[path] += 1
            _STACK.pop()
            self._range.__exit__(*exc)
            self._range = None
        elif self.clock:
            self.seconds = time.perf_counter() - self.t0
        return False


def count(label: str, n) -> None:
    """Add ``n`` (bytes copied, say) to the counter ``#<label>``."""
    if _ENABLED:
        _TOTALS[COUNTER + label] += n
        _COUNTS[COUNTER + label] += 1


def iterate(label: str, it):
    """``it`` itself while profiling is off; else an iterator over it that
    times each ``next()`` under ``label``, with no range (one an item would
    flood the trace)."""
    if not _ENABLED:
        return it
    return _timed_steps(label, iter(it))


def _timed_steps(label: str, it):
    while True:
        _STACK.append(label)
        path = "/".join(_STACK)
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            _TOTALS[path] += time.perf_counter() - t0
            _COUNTS[path] += 1
            _STACK.pop()
        yield item


def report(out=None) -> None:
    """Scopes by path (seconds, calls), then the counters (total, adds)."""
    out = out or sys.stderr
    scopes = [p for p in _TOTALS if not p.startswith(COUNTER)]
    for path in sorted(scopes, key=lambda p: -_TOTALS[p]):
        out.write(f"{_TOTALS[path]:10.3f}s  {_COUNTS[path]:8d}x  {path}\n")
    for key in sorted(set(_TOTALS) - set(scopes)):
        out.write(f"{int(_TOTALS[key]):14d}  {_COUNTS[key]:8d}x  {key}\n")


def totals() -> dict[str, float]:
    """Seconds per call path so far, and each counter under ``#<label>``."""
    return dict(_TOTALS)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()
