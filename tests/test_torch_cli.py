"""``goss build-graph`` of the PyTorch port against the JAX CLI.

On the ``tests/test_cli_goss.py`` fixture every file the port writes
under ``-O`` must be byte-identical to the JAX CLI's, and the graph must
equal the brute-force model.  A subprocess with jax blocked proves the
port never imports it.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.io.factory import PhysicalFileFactory
from gossamer_tpu_torch.io.readers import read_files
from gossamer_tpu_torch.ops.count import count_rho_mers, count_rho_mers_files

from specmodel import spectrum_build_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = (".header", ".edges-lo", ".counts", "-counts-hist.txt")


@pytest.fixture
def tiny(tmp_path):
    """The fixture of tests/test_cli_goss.py."""
    rng = random.Random(42)
    genome = "".join(rng.choice("ACGT") for _ in range(400))
    reads = []
    for _ in range(60):
        p = rng.randrange(0, len(genome) - 60)
        r = genome[p : p + 60]
        if rng.random() < 0.5:
            r = "".join("TGCA"["ACGT".index(c)] for c in reversed(r))
        reads.append(r)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return tmp_path, reads, str(fa)


def test_build_graph_files_match_jax_cli(tiny):
    tmp, reads, fa = tiny
    args = ["build-graph", "-k", "11", "-I", fa, "--chunk-size", "4096"]
    assert jax_app().main(args + ["-O", str(tmp / "gj")]) == 0
    assert port_main(args + ["-O", str(tmp / "gt"), "--device", "cpu"]) == 0
    written = sorted(n for n in os.listdir(tmp) if n.startswith("gt"))
    assert written == sorted("gt" + s for s in SUFFIXES)
    for suffix in SUFFIXES:
        assert (tmp / ("gt" + suffix)).read_bytes() == \
            (tmp / ("gj" + suffix)).read_bytes(), suffix
    g = Graph.read(str(tmp / "gt"), PhysicalFileFactory())
    got = {int(k): int(c) for k, c in zip(g.lo, g.counts)}
    assert got == spectrum_build_graph(reads, 12)
    assert g.lint() == []


def test_python_reader_route_matches_native(tiny):
    _tmp, reads, fa = tiny
    kw = dict(both_strands=True, canonical=False, device=torch.device("cpu"),
              chunk=1024)
    native = count_rho_mers_files([fa], 12, **kw)
    python = count_rho_mers(read_files([fa]), 12, **kw)
    for a, b in zip(native, python):
        assert np.array_equal(a, b)
    assert native[2].sum() == sum(spectrum_build_graph(reads, 12).values())


def test_port_runs_with_jax_blocked(tiny):
    tmp, _reads, fa = tiny
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gossamer_tpu'] = None\n"
        "from gossamer_tpu_torch.cli.goss import main\n"
        f"rc = main(['build-graph', '-k', '11', '-I', {fa!r}, '-O', "
        f"{str(tmp / 'gb')!r}, '--chunk-size', '4096', '--device', 'cpu'])\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'gossamer_tpu')]\n"
        "raise SystemExit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp / "gb.edges-lo").exists()


def test_device_cuda_without_cuda_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tmp, _reads, fa = tiny
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["build-graph", "-k", "11", "-I", fa, "-O", str(tmp / "g")])
    assert not (tmp / "g.header").exists()


@pytest.mark.parametrize("kw,msg", [({"n_devices": 2}, "several devices")])
def test_unported_counting_raises(tiny, kw, msg, monkeypatch):
    """Counting on several devices is ported: 2 CPU shards give the one
    device's spectrum; on cuda with one card visible it raises, never a
    smaller mesh."""
    _tmp, _reads, fa = tiny
    args = dict(both_strands=False, canonical=False, chunk=1024)
    cpu = torch.device("cpu")
    want = count_rho_mers_files([fa], 12, device=cpu, **args)
    got = count_rho_mers_files([fa], 12, device=cpu, **args, **kw)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=f"{msg}: .* and 1 are visible"):
        count_rho_mers_files([fa], 12, device=torch.device("cuda"), **args,
                             **kw)


def test_wide_keys_raise(tiny):
    """Wide keys count up to rho = 63 (126 bits); beyond that they raise."""
    tmp, reads, fa = tiny
    kw = dict(both_strands=True, canonical=False, device=torch.device("cpu"),
              chunk=1024)
    lo, hi, counts = count_rho_mers_files([fa], 41, **kw)
    want = spectrum_build_graph(reads, 41)
    assert {(int(h) << 64) | int(l): int(c)
            for l, h, c in zip(lo, hi, counts)} == want and hi.any()
    with pytest.raises(ValueError, match="126 bits"):
        count_rho_mers_files([fa], 64, **kw)


# ----------------------------------------------- the file factory (C.9)
@pytest.mark.parametrize("cmd,k", [("build-graph", "11"), ("build-graph", "40"),
                                   ("build-kmer-set", "11")])
def test_counting_reads_through_the_file_factory(tiny, cmd, k):
    """A command given a non-physical file factory counts the reads it
    holds, as the JAX command does, and writes the files of a count from
    disk."""
    from gossamer_tpu_torch.cli.framework import Context
    from gossamer_tpu_torch.cli.goss import build_app
    from gossamer_tpu_torch.io.factory import StringFileFactory
    from gossamer_tpu_torch.utils.logging import Logger

    tmp, _reads, fa = tiny
    fac = StringFileFactory()
    fac.add_file("in-memory.fa", open(fa, "rb").read())
    app = build_app()
    args = [cmd, "-k", k, "--chunk-size", "4096", "--device", "cpu"]
    ns = app.build_parser().parse_args(args + ["-I", "in-memory.fa", "-O", "m"])
    app.commands[cmd].run(Context(fac=fac, log=Logger(None), opts=ns,
                                  device=torch.device("cpu")))
    assert not os.path.exists("in-memory.fa")
    assert port_main(args + ["-I", fa, "-O", str(tmp / "d")]) == 0
    disk = {n[1:]: (tmp / n).read_bytes() for n in os.listdir(tmp)
            if n.startswith("d.") or n.startswith("d-")}
    assert {n[1:]: b for n, b in fac.files.items() if n[:2] in ("m.", "m-")} \
        == disk and len(disk) >= 3


# ------------------------------------------------ -B for wide keys (C.10)
@pytest.mark.parametrize("chunk", [1 << 22, 1 << 20, 4096])
def test_wide_sizing_keeps_a_flush_within_the_buffer(chunk):
    from gossamer_tpu_torch.cmds.basic import (FLUSH_CHUNKS, WIDE_KEY_BYTES,
                                               WIDE_WINDOW_BYTES, wide_sizing)

    for gb in (1, 2, 3, 4, 8, 16, 80):
        cap, batch, fits = wide_sizing(gb, chunk)
        n = batch * chunk
        peak = WIDE_KEY_BYTES * cap + WIDE_WINDOW_BYTES * n
        assert batch in FLUSH_CHUNKS and cap >= 2 * n
        assert fits == (peak <= gb << 30)
        if batch < FLUSH_CHUNKS[0] and fits:  # no more chunks would fit
            m = 2 * batch * chunk
            assert WIDE_KEY_BYTES * 2 * m + WIDE_WINDOW_BYTES * m > gb << 30
    assert wide_sizing(2, 1 << 22) == (11093630, 1, True)
    assert wide_sizing(1, 1 << 22)[2] is False


def test_buffer_size_leaves_the_narrow_cap_and_every_spectrum(tiny):
    from gossamer_tpu_torch.cli.goss import build_app
    from gossamer_tpu_torch.cmds.basic import _chunk_kwargs, wide_sizing

    _tmp, _reads, fa = tiny
    ns = build_app().build_parser().parse_args(
        ["build-graph", "-k", "11", "-I", fa, "-O", "g", "-B", "3"])

    class Ctx:
        opts, device = ns, torch.device("cpu")

        @staticmethod
        def log(*_a):
            pass

    assert _chunk_kwargs(Ctx, 12)["cap_entries"] == (3 << 30) // 48
    assert _chunk_kwargs(Ctx, 12)["batch"] == 8
    wide = _chunk_kwargs(Ctx, 41)
    assert (wide["cap_entries"], wide["batch"], True) == wide_sizing(3, 1 << 22)
    kw = dict(both_strands=True, canonical=False, device=torch.device("cpu"),
              chunk=256)
    want = count_rho_mers_files([fa], 41, **kw)
    for cap, batch in ((600, 1), (2000, 2)):  # small caps: the count spills
        got = count_rho_mers_files([fa], 41, cap_entries=cap, batch=batch, **kw)
        for a, b in zip(want, got):
            assert np.array_equal(a, b)
