"""The traced run's records: the benchmark's own spans around calls into the
program, and the reduction of the profiler's trace to device time.

A span target is ``"<module>:<attribute path>"``, the name where the
program binds the callable, so the wrapper sees every call that goes
through that binding.  Kinds:

* ``call``: the host seconds inside each call;
* ``iter``: the host seconds inside each step of the iterator the call
  returns (the call itself is taken eagerly);
* ``kernel``: a ``call`` whose device ops are attributed to it from the
  trace, with the least time of its work: ``bound``, a function of the
  call's arguments that the metric file gives (see
  :mod:`benchmark.roofline`).

Each span is also a ``torch.profiler.record_function`` range named
``bench.<name>`` (``bench.<name>#<i>`` for kernels), so the trace holds it.
"""

from __future__ import annotations

import bisect
import importlib
import inspect
import json
import time
from collections import defaultdict

PREFIX = "bench."
CALL = "call"  # the span of one whole call of the entry
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _resolve(target: str):
    """-> (owner object, attribute name, the object as bound there)."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr, inspect.getattr_static(owner, attr)


class Spans:
    """Installs the span wrappers and keeps their records: seconds per span
    name for the current call, and each kernel call's bound."""

    def __init__(self, specs: list[dict]):
        self.specs = specs
        self._undo = []
        self.current: dict[str, float] = defaultdict(float)
        self.kernel_calls: dict[str, list[float]] = defaultdict(list)

    def install(self) -> None:
        for spec in self.specs:
            owner, attr, orig = _resolve(spec["target"])
            self._undo.append((owner, attr, orig))
            setattr(owner, attr, self._wrap(spec, orig))

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def begin_call(self) -> None:
        self.current = defaultdict(float)

    def _wrap(self, spec: dict, orig):
        import torch

        name, kind = spec["name"], spec["kind"]
        fn = orig.__func__ if isinstance(orig, (classmethod, staticmethod)) else orig
        record = torch.profiler.record_function
        spans = self

        def timed(label, thunk):
            t0 = time.perf_counter()
            try:
                with record(label):
                    return thunk()
            finally:
                spans.current[name] += time.perf_counter() - t0

        if kind == "iter":
            def wrapper(*args, **kwargs):
                it = iter(timed(PREFIX + name, lambda: fn(*args, **kwargs)))

                def steps():
                    while True:
                        try:
                            item = timed(PREFIX + name, lambda: next(it))
                        except StopIteration:
                            return
                        yield item
                return steps()
        elif kind == "kernel":
            bound = spec["bound"]

            def wrapper(*args, **kwargs):
                calls = spans.kernel_calls[name]
                label = f"{PREFIX}{name}#{len(calls)}"
                calls.append(bound(*args, **kwargs))
                return timed(label, lambda: fn(*args, **kwargs))
        elif kind == "call":
            def wrapper(*args, **kwargs):
                return timed(PREFIX + name, lambda: fn(*args, **kwargs))
        else:
            raise ValueError(f"span {name}: unknown kind {kind!r}")
        if isinstance(orig, classmethod):
            return classmethod(wrapper)
        if isinstance(orig, staticmethod):
            return staticmethod(wrapper)
        return wrapper


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_trace(path: str, kernel_bounds: dict[str, list[float]],
                 top: int = 10) -> dict:
    """The profiler's Chrome trace -> device records over the calls'
    intervals (``bench.call`` ranges): ``busy_s`` (the union of device op
    intervals), ``window_s`` (the calls' length), each kernel call's device
    seconds (its device ops, found by the correlation of their launches
    inside its range), the device ops that took the most time, and the
    longest idle gaps named by the innermost benchmark span open on the host
    at the gap's middle.  Times in the trace are microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, device = [], {}, []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                          e["name"][len(PREFIX):], e.get("tid")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                           e.get("name", "?"), args.get("correlation")))
    calls = sorted((s, e) for s, e, n, _ in spans if n == CALL)
    window_us = sum(e - s for s, e in calls)

    busy = []
    by_name = defaultdict(float)
    for lo, hi in calls:
        inside = _clip([(s, e) for s, e, _, _ in device], lo, hi)
        busy.extend(_union(inside))
        for s, e, name, _ in device:
            if e > lo and s < hi:
                by_name[name] += (min(e, hi) - max(s, lo)) * 1e-6
    busy = _union(busy)
    busy_us = sum(e - s for s, e in busy)

    kernel_device = {}
    for kname, bounds in kernel_bounds.items():
        ranges = sorted((s, e, tid, int(n.split("#")[1])) for s, e, n, tid in spans
                        if n.startswith(kname + "#"))
        starts = [r[0] for r in ranges]
        secs = defaultdict(float)
        for s, e, _, corr in device:
            launch = launches.get(corr)
            j = bisect.bisect_right(starts, launch[0]) - 1 if launch else -1
            if j >= 0 and launch[0] <= ranges[j][1] and launch[1] == ranges[j][2]:
                secs[ranges[j][3]] += (e - s) * 1e-6
        kernel_device[kname] = [(bounds[i], d) for i, d in sorted(secs.items())
                                if i < len(bounds)]

    gaps = []
    for lo, hi in calls:
        edges = [lo] + [x for iv in _clip(busy, lo, hi) for x in iv] + [hi]
        gaps.extend((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = [(s, e, n) for s, e, n, _ in spans if n != CALL and "#" not in n]
    idle = []
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [(ss, n) for ss, ee, n in named if ss <= mid <= ee]
        idle.append([max(open_)[1] if open_ else CALL, (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "kernels": kernel_device,
        "device_ops": [[n, s] for n, s in ops[:top]],
        "idle_gaps": idle,
        "n_device_ops": len(device),
        "n_launches": len(launches),
    }
