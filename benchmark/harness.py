"""One run of one cell: set-up, the window, the traced records, the check
against the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix, entry or
metric is a file of its own, found by name (see README.md):

* ``workloads/<cell>.json``: the entry and its command line (a template
  over the inputs and the configuration); the cell's configuration,
  traffic mix and why are its entry in ``BENCHMARK.json``;
* ``configs/<config>.json``: the deployment's sizes, cuts and guarantees;
* ``traffic/<mix>.json``: the mix's parameters and the generator module
  (``traffic/<generator>.py``) that reads them;
* ``entries/<entry>.py``: how to call the program, what it writes, and how
  that is compared with ``reference/``;
* ``end_to_end/<metric>.py``: one end-to-end metric, read from the
  window's records;
* ``metrics/<metric>.py``: one per-layer metric, read from the traced run's
  records, with the spans it needs.

A cell reports the metrics of ``BENCHMARK.json`` that apply to it (those
without ``workloads``, and those whose ``workloads`` name it).
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gossamer_tpu")
# the program's fixed build directory inside the checkout
PROGRAM_BUILD = REPO / "gossamer_tpu_torch" / "_build"
NAME_CHARS = 160  # a device op's name in the breakdown, cut to this


class BenchError(Exception):
    """The run cannot give a result (no card, a wrong route, bad files)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise BenchError(f"no module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_state() -> dict[str, float]:
    """The program's built libraries: name -> modification time."""
    if not PROGRAM_BUILD.is_dir():
        return {}
    return {p.name: p.stat().st_mtime for p in PROGRAM_BUILD.iterdir()
            if p.suffix == ".so"}


def file_digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        h.update(b"\0")
    return h.hexdigest()


class Cell:
    """A cell's files, merged with ``overrides`` (the CPU tests' small
    sizes: ``config``, ``traffic`` and extra ``argv`` words)."""

    def __init__(self, name: str, overrides: dict | None = None):
        overrides = overrides or {}
        bench = load_json(REPO / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        self.chips = self.spec["chips"]
        self.workload = load_json(ROOT / "workloads" / f"{name}.json")
        self.config = {**load_json(ROOT / "configs" / f"{self.spec['config']}.json"),
                       **overrides.get("config", {})}
        self.mix = {**load_json(ROOT / "traffic" / f"{self.spec['traffic']}.json"),
                    **overrides.get("traffic", {})}
        self.extra_argv = list(overrides.get("argv", []))
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.readers = {m["name"]: load_module(ROOT / "end_to_end" / f"{m['name']}.py",
                                               f"bench_e2e_{i}")
                        for i, m in enumerate(self.end_to_end)}
        self.metrics = {m["name"]: load_module(ROOT / "metrics" / f"{m['name']}.py",
                                               f"bench_metric_{i}")
                        for i, m in enumerate(self.per_layer)}
        self.entry_module = importlib.import_module(
            f"benchmark.entries.{self.workload['entry']}")


class Context:
    """What an entry gets: the cell, its inputs, its directory, the device
    words of the command line."""

    def __init__(self, cell: Cell, inputs: dict, workdir: Path, device: str):
        self.cell = cell
        self.inputs = inputs
        self.workdir = workdir
        self.device = device
        scalars = {k: v for k, v in {**cell.config, **inputs}.items()
                   if isinstance(v, (str, int, float))}
        self.fields = {**scalars, "workdir": str(workdir)}
        # on the card the CLIs run at their default --device (cuda)
        self.device_argv = [] if device == "cuda" else ["--device", device]

    def argv(self, key: str = "argv") -> list[str]:
        return ([w.format(**self.fields) for w in self.cell.workload[key]]
                + self.device_argv + self.cell.extra_argv)


def _card(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"{torch.cuda.device_count()} cards visible, the cell "
                         f"asks for {chips}")
    torch.cuda.init()
    torch.zeros(1, device="cuda").sum().item()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def tmp_dir() -> Path:
    """``TMPDIR``, which the caller gives each run; no fixed fallback."""
    tmp = os.environ.get("TMPDIR")
    if not tmp:
        raise BenchError("TMPDIR is not set: the inputs are written under it")
    return Path(tmp)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", workdir: Path | None = None,
        overrides: dict | None = None, fault=None, log=sys.stderr) -> dict:
    """One run -> the result object.  ``device="cpu"`` (the CPU tests) skips
    the look for a card and runs the program's CPU path; ``fault`` (tests)
    is called with the entry after set-up, to break the timed path."""
    t_start = process_start()
    cell = Cell(cell_name, overrides)
    dev_info = _card(cell.chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    if workdir is None:
        workdir = tmp_dir() / "gossamer-bench" / cell_name
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        return _run(cell, seed, seconds, trace, device, workdir, dev_info,
                    t_start, fault, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, workdir, dev_info, t_start,
         fault, log) -> dict:
    import torch

    from . import tracing

    say = lambda msg: print(msg, file=log, flush=True)  # noqa: E731
    generator = importlib.import_module(f"benchmark.traffic.{cell.mix['generator']}")
    libs = build_state()
    t0 = time.time()
    inputs = generator.make(cell.config, cell.mix, seed, workdir)
    t1 = time.time()
    ctx = Context(cell, inputs, workdir, device)
    entry = cell.entry_module.Entry(ctx)
    entry.prepare()
    t2 = time.time()
    warm = {}
    if entry.call() != 0:
        raise BenchError("the warm-up call failed")
    t3 = time.time()
    # what set-up built (the entry's own set-up or the warm-up call): a
    # checkout's first run builds the program's libraries, later runs find them
    built = sorted(n for n, t in build_state().items() if libs.get(n) != t)
    entry.after_call(warm)
    say(f"set-up: process start to inputs {t0 - t_start:.3f} s, inputs "
        f"{t1 - t0:.3f} s, prepare {t2 - t1:.3f} s, warm-up call {t3 - t2:.3f} s, "
        f"built: {', '.join(built) or 'nothing'}")
    if fault is not None:
        fault(entry)

    spans = None
    profile = None
    if trace:
        specs = {}
        for mod in [entry, *cell.metrics.values()]:
            for s in getattr(mod, "SPANS", []):
                specs[(s["name"], s["target"])] = s
        spans = tracing.Spans(list(specs.values()))
        spans.install()
        targets = {getattr(m, "PROFILE") for m in cell.metrics.values()
                   if getattr(m, "PROFILE", None)}
        if len(targets) > 1:
            raise BenchError(f"metrics name several profilers: {targets}")
        if targets:
            profile = importlib.import_module(targets.pop())
            profile.enable()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    calls = []
    total = 0.0
    try:
        while total < seconds:
            rec = {}
            if spans is not None:
                spans.begin_call()
            if profile is not None:
                profile.reset()
            with torch.profiler.record_function(tracing.PREFIX + tracing.CALL):
                t0 = time.perf_counter()
                rc = entry.call()
                wall = time.perf_counter() - t0
            rec.update(wall_s=wall, rc=rc)
            if spans is not None:
                rec["spans"] = dict(spans.current)
            if profile is not None:
                rec["profile"] = profile.totals()
            if rc == 0:
                entry.after_call(rec)
            calls.append(rec)
            total += wall
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if spans is not None:
            spans.restore()
        if profile is not None:
            profile.enable(False)

    say("calls (s): " + " ".join(f"{c['wall_s']:.3f}" for c in calls))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    dev_info["memory_peak_bytes"] = int(peak)
    ok_calls = [c for c in calls if c["rc"] == 0]
    failed = len(calls) - len(ok_calls)
    metrics = {}
    breakdown = None
    if not trace:
        window = {"calls": ok_calls, "setup_s": setup_s, "peak_bytes": peak}
        for m in cell.end_to_end:
            value = cell.readers[m["name"]].read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        records = {"calls": ok_calls, "kernels": {}, "device": None}
        if device == "cuda":
            path = workdir / "trace.json"
            prof.export_chrome_trace(str(path))
            red = tracing.reduce_trace(str(path), spans.kernel_calls)
            path.unlink()
            records["kernels"] = red["kernels"]
            records["device"] = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
            dev_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
            breakdown = {"device_ops": [[n[:NAME_CHARS], v] for n, v in red["device_ops"]],
                         "idle_gaps": red["idle_gaps"]}
            say(f"trace: {red['n_device_ops']} device ops, {red['n_launches']} "
                f"launches, busy {red['busy_s']} s of {red['window_s']} s")
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, mod in cell.metrics.items():
            value = mod.read(records)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    del prof, spans
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        dev_info["power_limit_w"] = power_limit_w()

    # the comparison with the plain reference, after the window
    digests = [c["digest"] for c in [warm, *ok_calls]]
    checks = {"calls_unlike_last": (sum(d != digests[-1] for d in digests), 0)}
    t0 = time.time()
    checks.update(entry.compare())
    say(f"reference and comparison: {time.time() - t0:.3f} s")
    for line in entry.notes():
        say(line)
    found = forbidden_modules()
    if found:
        raise BenchError(f"sys.modules holds {found}: the run loaded the JAX "
                         f"package or JAX")
    correct = failed == 0 and len(ok_calls) > 0 and all(
        v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = {"built": built, "warm_up_s": t3 - t2}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        say(f"check {k}: {v} (limit {lim})")
    return result
