"""The port's profiler (``gossamer_tpu_torch.utils.profile``) on the CPU:
scopes nest into paths and, while on, open ``torch.profiler`` ranges named
by their paths; counters sit under ``#`` keys; while off nothing is
recorded and the per-item helper hands back what it was given.  Then the
scopes at the work sites of a small ``goss build-graph`` that spills and a
small ``xenome classify``: present, the older paths unchanged, the files
byte-identical with profiling on and off."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gossamer_tpu_torch.cli.goss import main as goss_main
from gossamer_tpu_torch.cli.xenome import main as xenome_main
from gossamer_tpu_torch.utils import profile

REPO = Path(__file__).resolve().parents[1]
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def profile_off():
    profile.enable(False)
    profile.reset()
    yield
    profile.enable(False)
    profile.reset()


def range_names(fn) -> set[str]:
    """Names of the events a CPU ``torch.profiler`` run of ``fn`` records."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return {e.name for e in prof.events()}


def nested():
    with profile.context("outer"):
        with profile.context("inner/step"):
            torch.ones(4).sum()
        with profile.context("inner/step"):
            pass


def test_scopes_nest_into_paths():
    profile.enable()
    nested()
    t = profile.totals()
    assert set(t) == {"outer", "outer/inner/step"}
    assert t["outer"] >= t["outer/inner/step"] >= 0.0
    out = io.StringIO()
    profile.report(out)
    lines = out.getvalue().splitlines()
    assert lines[-1].endswith("2x  outer/inner/step")


def test_off_records_nothing_and_opens_no_range():
    names = range_names(nested)
    assert profile.totals() == {}
    assert not {"outer", "outer/inner/step"} & names
    profile.count("d2h_bytes", 10)
    assert profile.totals() == {}


def test_on_opens_a_range_named_by_each_path():
    profile.enable()
    names = range_names(nested)
    assert {"outer", "outer/inner/step"} <= names


def test_counters_under_hash_keys_and_reset_clears():
    profile.enable()
    with profile.context("copy"):
        profile.count("h2d_bytes", 100)
        profile.count("h2d_bytes", 28)
    t = profile.totals()
    assert t["#h2d_bytes"] == 128 and "copy" in t
    assert not any(k.startswith(profile.COUNTER) for k in t if k != "#h2d_bytes")
    out = io.StringIO()
    profile.report(out)
    # counters print apart, after every scope
    assert out.getvalue().splitlines()[-1].split() == ["128", "2x", "#h2d_bytes"]
    profile.reset()
    assert profile.totals() == {}


def test_iterate_hands_back_the_very_iterator_when_off():
    it = iter(range(3))
    assert profile.iterate("read", it) is it
    assert list(it) == [0, 1, 2] and profile.totals() == {}


def test_clock_scope_keeps_its_seconds_when_off():
    clock = profile.context("phase", clock=True)
    with clock:
        pass
    assert clock.seconds > 0.0 and profile.totals() == {}


def test_iterate_adds_seconds_but_no_range_when_on():
    profile.enable()

    def run():
        with profile.context("call"):
            got = list(profile.iterate("read", [1, 2, 3]))
        assert got == [1, 2, 3]

    names = range_names(run)
    assert {"call", "call/read"} <= set(profile.totals())
    assert "call" in names and "call/read" not in names
    out = io.StringIO()
    profile.report(out)
    assert "4x  call/read" in out.getvalue()  # three items and the end


def test_no_environment_switch():
    env = {**os.environ, "GOSSAMER_TPU_PROFILE": "1"}
    code = ("from gossamer_tpu_torch.utils import profile\n"
            "print(profile.enabled())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "False"


# ------------------------------------------------------------ build-graph
def fastq(path: Path, seqs) -> None:
    path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                            for i, s in enumerate(seqs)))


def run_cli(main, argv, profiled: bool):
    """-> (stdout, stderr, the profile's totals or None)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv + (["-D", "print-profile"] if profiled else [])) == 0
    assert not profile.enabled()  # the switch is restored after the call
    return out.getvalue(), err.getvalue(), (profile.totals() if profiled else None)


def files_of(prefix: Path) -> dict[str, bytes]:
    return {p.name[len(prefix.name):]: p.read_bytes()
            for p in sorted(prefix.parent.glob(prefix.name + "*"))
            if p.suffix != ".log"}


def count_line(log: Path) -> dict:
    line = [l for l in log.read_text().splitlines() if "\tcount: " in l][0]
    return json.loads(line.split("phases (s) ", 1)[1])


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """A build-graph whose cap forces spills, profiled and not."""
    tmp = tmp_path_factory.mktemp("profile_build")
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 12_000)
    starts = rng.integers(0, len(genome) - 100, 1_200)
    fastq(tmp / "reads.fq", [ACGT[genome[p:p + 100]].tobytes().decode()
                             for p in starts])
    runs = {}
    for on in (False, True):
        name = "on" if on else "off"
        argv = ["build-graph", "-k", "25", "-i", str(tmp / "reads.fq"),
                "-O", str(tmp / name), "--device", "cpu", "--chunk-size",
                "4096", "--spectrum-cap", "16384", "-l", str(tmp / f"{name}.log")]
        _out, err, totals = run_cli(goss_main, argv, on)
        runs[name] = (err, totals, files_of(tmp / name),
                      count_line(tmp / f"{name}.log"), (tmp / f"{name}.log").read_text())
    profile.reset()
    return runs


def test_build_graph_scopes_and_counters(build):
    err, t, *_ = build["on"]
    for label in ("spill", "decode", "merge", "sync", "to_host",
                  "graph/write/hist", "build-graph/graph", "count/read"):
        assert any(p == label or p.endswith("/" + label) for p in t), label
    assert "count/add_chunk/spill" in t and "count/finish/pull/decode" in t
    assert t["#d2h_bytes"] > 0 and t["#h2d_bytes"] > 0
    assert "#d2h_bytes" in err and "count/finish/pull/merge" in err
    # the histogram counted once; the two arrays' bytes written
    assert t["#hist_counted"] == 1 and "#hist_sorted" not in t
    files = build["on"][2]
    assert t["#write_bytes"] == sum(np.load(io.BytesIO(files[s])).nbytes
                                    for s in (".edges-lo", ".counts"))
    assert "#hist_counted" in err and "#write_bytes" in err


def test_build_graph_keeps_older_paths_and_phase_keys(build):
    _err, t, _files, phases, log = build["on"]
    assert {"count/add_chunk", "count/finish"} <= set(t)
    assert "spills" in log and " 0 spills" not in log
    for name in ("on", "off"):
        assert list(build[name][3]) == ["stream", "flush_tail", "pull", "expand"]
    # the phases are their scopes' seconds: one clock reading each
    for key in ("flush_tail", "pull", "expand"):
        assert phases[key] == t[f"count/finish/{key}"]


def test_build_graph_files_identical_on_and_off(build):
    on, off = build["on"][2], build["off"][2]
    assert set(on) == {".header", ".edges-lo", ".counts", "-counts-hist.txt"}
    assert on == off
    assert build["off"][0] == ""  # no report without the flag


# --------------------------------------------------------- xenome classify
@pytest.fixture(scope="module")
def classify(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profile_xenome")
    rng = np.random.default_rng(9)
    graft = rng.integers(0, 4, 2_000)
    host = graft.copy()
    host[:1_200] = rng.integers(0, 4, 1_200)
    host[::89] = (host[::89] + 1) % 4
    (tmp / "graft.fa").write_text(f">g\n{ACGT[graft].tobytes().decode()}\n")
    (tmp / "host.fa").write_text(f">h\n{ACGT[host].tobytes().decode()}\n")
    seqs = []
    for i in range(200):
        src = (graft, host, rng.integers(0, 4, 100))[i % 3]
        p = int(rng.integers(0, len(src) - 60))
        seqs.append(ACGT[src[p:p + 60]].tobytes().decode())
    fastq(tmp / "reads.fq", seqs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert xenome_main(["index", "-K", "13", "-G", str(tmp / "graft.fa"),
                            "-H", str(tmp / "host.fa"), "-P", str(tmp / "idx"),
                            "--device", "cpu"]) == 0
    runs = {}
    for on in (False, True):
        name = "on" if on else "off"
        argv = ["classify", "-P", str(tmp / "idx"), "-i", str(tmp / "reads.fq"),
                "--output-filename-prefix", str(tmp / name), "--device", "cpu"]
        out, _err, totals = run_cli(xenome_main, argv, on)
        runs[name] = (out, totals, files_of(tmp / name))
    profile.reset()
    return runs


def test_classify_scopes_new_and_old(classify):
    _out, t, _files = classify["on"]
    assert {"xenome/index_load", "classify/index", "classify/read",
            "xenome/write"} <= set(t)
    assert {"classify/encode", "classify/pack", "classify/launch",
            "classify/wait"} <= set(t)
    assert t["#h2d_bytes"] > 0 and t["#d2h_bytes"] == 200  # a byte a read


def test_classify_files_identical_on_and_off(classify):
    on, off = classify["on"], classify["off"]
    assert on[0] == off[0]  # the statistics
    assert len(on[2]) == 5 and on[2] == off[2]
    assert sum(len(v) for v in on[2].values()) > 0


# ------------------------------------------------------------ wide count
@pytest.fixture(scope="module", params=[(8192, 1 << 20), (1024, 1 << 14)],
                ids=["unspilled", "spilled"])
def wide(request):
    """A profiled wide count (rho 56) of 300 random reads: in flushes whose
    first cap holds every class, or in small flushes under a small cap,
    which spill."""
    from gossamer_tpu_torch.io.readers import Read
    from gossamer_tpu_torch.io.stream import flat_code_chunks
    from gossamer_tpu_torch.ops.engine_wide import SpectrumEngineWide

    chunk, cap = request.param
    rng = np.random.default_rng(56)
    reads = [Read(str(i), ACGT[rng.integers(0, 4, 150)].tobytes())
             for i in range(300)]
    spilled = []
    eng = SpectrumEngineWide(56, "value", chunk, torch.device("cpu"), batch=4,
                             cap=cap, on_spill=lambda i, n: spilled.append(n))
    profile.reset()
    profile.enable()
    try:
        for codes in flat_code_chunks(reads, 56, chunk=chunk):
            eng.add_chunk(codes)
        out = eng.finish_expanded()
    finally:
        profile.enable(False)
    totals = profile.totals()
    profile.reset()
    return eng, out, spilled, totals


def test_wide_count_scopes_and_counters(wide):
    eng, out, spilled, t = wide
    for label in ("wide/flush", "sync", "flush_tail", "expand", "pull", "to_host"):
        assert any(p == label or p.endswith("/" + label) for p in t), label
    assert "flush_tail/wide/flush" in t  # the final flush under the finish
    assert t.get("#spill_runs", 0) == eng.spills == len(spilled)
    assert (eng.spills > 0) == (eng.req_cap == 1 << 14)
    if eng.spills:
        assert "spill" in t
        # each spilled run and the live lanes at the finish: 24 B a lane
        final = int(eng.live_scalars[-1])
        assert t["#d2h_bytes"] == 24 * (sum(spilled) + final)
    else:  # the expanded spectrum's three planes
        assert t["#d2h_bytes"] == sum(a.nbytes for a in out)
    assert len(out[0]) == 2 * 300 * (150 - 56 + 1)  # random reads: all distinct


def test_wide_phases_are_the_scopes_readings(wide):
    eng, _out, _spilled, t = wide
    keys = ["flush_tail", "pull", "expand"] if eng.spills else \
        ["flush_tail", "expand", "pull"]
    assert list(eng.phases) == keys
    for key in keys:
        assert eng.phases[key] == t[key]
