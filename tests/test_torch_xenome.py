"""``xenome index`` and ``xenome classify`` of the PyTorch port against the
JAX CLI.

On a small graft/host pair (k = 13) and N-free reads, every index file,
every output file of ``classify`` (single reads, ``--pairs``, ``-M``) and
the statistics it prints must be byte-identical to the JAX CLI's;
multi-pass classification must equal the JAX library's.  A subprocess
with jax blocked proves the port never imports it.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossamer_tpu.classify.annotated_set import AnnotatedKmerSet as JaxAnn
from gossamer_tpu.classify.xenome import classify_reads as jax_classify_reads
from gossamer_tpu.cli.xenome import build_app as jax_app
from gossamer_tpu.io.factory import PhysicalFileFactory as JaxFac
from gossamer_tpu.io.readers import Read as JaxRead
from gossamer_tpu_torch.classify.annotated_set import AnnotatedKmerSet
from gossamer_tpu_torch.classify.xenome import classify_reads
from gossamer_tpu_torch.cli.xenome import main as port_main
from gossamer_tpu_torch.io.factory import PhysicalFileFactory
from gossamer_tpu_torch.io.readers import Read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)
INDEX_SUFFIXES = (".header", ".kmers-lo", ".kmers-hi", ".lhs-bits", ".rhs-bits")
CLASSES = ("neither", "both", "ambiguous", "graft", "host")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """graft.fa, host.fa, reads (FASTQ, two mate files) and both indexes."""
    tmp = tmp_path_factory.mktemp("xenome")
    rng = np.random.default_rng(77)
    shared = rng.integers(0, 4, 150)
    graft = np.concatenate([rng.integers(0, 4, 2500), shared])
    host = graft.copy()  # a diverged copy: marginal k-mers exist
    host[:2500] = rng.integers(0, 4, 2500)
    host[::97] = (host[::97] + 1) % 4
    (tmp / "graft.fa").write_text(f">g\n{ACGT[graft].tobytes().decode()}\n")
    (tmp / "host.fa").write_text(f">h\n{ACGT[host].tobytes().decode()}\n")
    seqs = []
    for i in range(300):
        src = (graft, host, shared, rng.integers(0, 4, 120))[i % 4]
        L = int(rng.integers(40, 80))
        p = int(rng.integers(0, len(src) - L))
        seqs.append(ACGT[src[p : p + L]].tobytes().decode())
    for name, part in (("reads.fq", seqs), ("r1.fq", seqs[0::2]),
                       ("r2.fq", seqs[1::2])):
        (tmp / name).write_text("".join(
            f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(part)))
    args = ["index", "-K", "13", "-G", str(tmp / "graft.fa"),
            "-H", str(tmp / "host.fa")]
    assert jax_app().main(args + ["-P", str(tmp / "ij")]) == 0
    assert port_main(args + ["-P", str(tmp / "it"), "--device", "cpu"]) == 0
    return tmp, seqs


def test_index_files_match_jax_cli(world):
    tmp, _seqs = world
    for suffix in INDEX_SUFFIXES:
        assert (tmp / ("it" + suffix)).read_bytes() == \
            (tmp / ("ij" + suffix)).read_bytes(), suffix
    ann = AnnotatedKmerSet.read(str(tmp / "it"), PhysicalFileFactory())
    assert (ann.lhs & ~ann.rhs).any() and (ann.rhs & ~ann.lhs).any()
    assert (ann.lhs & ann.rhs).any()


def run_classify(main, prefix, out_prefix, extra, port: bool) -> str:
    args = ["classify", "-P", prefix, "--output-filename-prefix", out_prefix,
            *extra]
    if port:
        args += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(args) == 0
    return out.getvalue()


@pytest.mark.parametrize("mode", ["single", "pairs", "max-memory",
                                  "dont-write-reads"])
def test_classify_outputs_match_jax_cli(world, mode):
    tmp, _seqs = world
    inputs = {"single": ["-i", str(tmp / "reads.fq")],
              "pairs": ["--pairs", "-i", str(tmp / "r1.fq"),
                        "-i", str(tmp / "r2.fq")],
              "max-memory": ["-M", "1", "-i", str(tmp / "reads.fq")],
              "dont-write-reads": ["--dont-write-reads", "-i",
                                   str(tmp / "reads.fq")]}[mode]
    oj, ot = str(tmp / f"{mode}-j"), str(tmp / f"{mode}-t")
    want = run_classify(jax_app().main, str(tmp / "ij"), oj, inputs, False)
    got = run_classify(port_main, str(tmp / "it"), ot, inputs, True)
    assert got == want
    halves = ("_1", "_2") if mode == "pairs" else ("",)
    for cls in CLASSES:
        for half in halves:
            jf, tf = f"{oj}_{cls}{half}.fastq", f"{ot}_{cls}{half}.fastq"
            assert os.path.exists(jf) == os.path.exists(tf)
            if os.path.exists(jf):
                assert open(tf).read() == open(jf).read(), (cls, half)
    if mode == "single":
        assert sum(int(line.split("\t")[4]) for line in
                   got.splitlines()[2:18]) == 300


def test_multipass_matches_jax(world):
    tmp, seqs = world
    ann = AnnotatedKmerSet.read(str(tmp / "it"), PhysicalFileFactory())
    jann = JaxAnn.read(str(tmp / "ij"), JaxFac())
    want = [b for _r, b in jax_classify_reads(
        [JaxRead(str(i), s.encode()) for i, s in enumerate(seqs)], jann,
        batch_reads=100, passes=3)]
    for passes in (1, 3):
        got = [b for _r, b in classify_reads(
            [Read(str(i), s.encode()) for i, s in enumerate(seqs)], ann,
            device=torch.device("cpu"), batch_reads=100, passes=passes)]
        assert got == want


def test_several_devices_raise(world, capsys, monkeypatch):
    """--num-devices 2 on a machine with one card raises and names the
    cards visible (no smaller mesh, no host fallback); on the CPU 2 shards
    give the one device's statistics."""
    tmp, _seqs = world
    args = ["classify", "-P", str(tmp / "it"), "-i", str(tmp / "reads.fq"),
            "--dont-write-reads"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        rc = port_main([*args, "--num-devices", "2", "--device", "cuda"])
    assert rc == 1
    assert "and 1 are visible" in capsys.readouterr().err
    stats = []
    for n in ("1", "2"):
        assert port_main([*args, "--num-devices", n, "--device", "cpu"]) == 0
        stats.append(capsys.readouterr().out)
    assert stats[0] == stats[1] and stats[0].count("\t") == 4


def test_device_cuda_without_cuda_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tmp, _seqs = world
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["index", "-K", "13", "-G", str(tmp / "graft.fa"),
                   "-H", str(tmp / "host.fa"), "-P", str(tmp / "ic")])
    assert not (tmp / "ic.header").exists()


def test_port_xenome_runs_with_jax_blocked(world):
    tmp, _seqs = world
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gossamer_tpu'] = None\n"
        "from gossamer_tpu_torch.cli.xenome import main\n"
        f"p, g, h = {str(tmp / 'ib')!r}, {str(tmp / 'graft.fa')!r}, "
        f"{str(tmp / 'host.fa')!r}\n"
        "assert main(['index', '-K', '13', '-G', g, '-H', h, '-P', p, "
        "'--device', 'cpu']) == 0\n"
        f"rc = main(['classify', '-P', p, '-i', {str(tmp / 'reads.fq')!r}, "
        "'--dont-write-reads', '--device', 'cpu'])\n"
        "assert not [m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'gossamer_tpu')]\n"
        "raise SystemExit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp / "ib.lhs-bits").exists()
