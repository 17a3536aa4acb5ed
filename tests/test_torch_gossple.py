"""The port's ``gossple`` against the JAX package's, and the global
``--kill-signal``.

On the input of ``tests/test_gossple.py`` (a 3 kbp random genome, 600
pairs of 70 bp reads, insert 200, k = 15) the port's ``gossple --device
cpu`` and the JAX ``gossple`` run every stage, from ``build-graph`` to
``print-contigs`` through the supergraph, ``thread-pairs``,
``thread-reads``, ``build-scaffold`` and ``scaffold``: every file each
writes must be byte-identical.  ``gossple`` passes ``--device`` to every
stage and, like every command, defaults to ``cuda``.
"""

import os
import random

import pytest
import torch

from gossamer_tpu.cli.gossple import main as jax_gossple
from gossamer_tpu_torch.cli.goss import build_app
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.cli.gossple import main as port_gossple
from gossamer_tpu_torch.utils.batch_task import KillSignal

from test_torch_contigs import GOSS_ARGS


def rc(s):
    return "".join("TGCA"["ACGT".index(c)] for c in reversed(s))


def write_pairs(tmp_path):
    rng = random.Random(55)
    genome = "".join(rng.choice("ACGT") for _ in range(3000))
    insert, rlen = 200, 70
    with open(tmp_path / "r1.fastq", "w") as f1, \
            open(tmp_path / "r2.fastq", "w") as f2:
        for i in range(600):
            p = rng.randrange(0, len(genome) - insert)
            frag = genome[p : p + insert]
            f1.write(f"@p{i}/1\n{frag[:rlen]}\n+\n{'I' * rlen}\n")
            f2.write(f"@p{i}/2\n{rc(frag[-rlen:])}\n+\n{'I' * rlen}\n")
    return genome


@pytest.fixture(scope="module")
def assembled(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gossple")
    genome = write_pairs(tmp)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        args = ["-k", "15", "-p", "r1.fastq", "r2.fastq",
                "--min-link-count", "3"]
        assert jax_gossple(args + ["-O", "j"]) == 0
        assert port_gossple(args + ["-O", "p", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    return tmp, genome


def outputs(tmp, stem):
    return {n[len(stem):]: (tmp / n).read_bytes() for n in sorted(os.listdir(tmp))
            if n.startswith(stem + "-") or n.startswith(stem + ".")}


def test_gossple_files_match_jax(assembled):
    tmp, _genome = assembled
    port, jax = outputs(tmp, "p"), outputs(tmp, "j")
    assert port == jax
    for name in ("-contigs.fa", "-supergraph.segments", "-entries.ends",
                 "-scaf.0.header", "-scaf.0.links", ".edges-lo"):
        assert name in port, name


def test_gossple_contigs_come_from_the_genome(assembled):
    tmp, genome = assembled
    text = (tmp / "p-contigs.fa").read_text()
    seqs = ["".join(c.splitlines()[1:]) for c in text.split(">") if c]
    grc = rc(genome)
    pieces = [p for s in seqs for p in s.split("N") if p]
    assert pieces and all(p in genome or p in grc for p in pieces)
    assert sum(len(p) for p in pieces) > 0.7 * len(genome)


def test_gossple_dry_run_passes_the_device(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "x.fa").write_text(">a\nACGT\n")
    assert port_gossple(["-I", "x.fa", "--dry-run", "-O", "z"]) == 0
    stages = capsys.readouterr().err.splitlines()
    assert stages[0].startswith("[stage 0] goss build-graph -k 27 -O z")
    assert stages[-1].endswith("print-contigs -G z --min-length 100 -o "
                               "z-contigs.fa") and len(stages) == 8


def test_gossple_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "x.fa").write_text(">a\nACGTACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_gossple(["-I", "x.fa", "-O", "z"])
    assert not (tmp_path / "z.header").exists()


@pytest.mark.parametrize("cmd", sorted(GOSS_ARGS))
def test_every_command_takes_kill_signal(cmd):
    ns = build_app().build_parser().parse_args(
        [cmd, *GOSS_ARGS[cmd], "--kill-signal", "stop-now"])
    assert ns.kill_signal == "stop-now" and ns.device == "cuda"


def test_kill_signal_is_registered(tmp_path):
    (tmp_path / "x.txt").write_text("#2011101014\n11\t0\t0\n")
    kill = str(tmp_path / "never-written")
    try:
        assert port_main(["restore-graph", "-f", str(tmp_path / "x.txt"),
                          "-O", str(tmp_path / "g"), "--kill-signal", kill,
                          "--device", "cpu"]) == 0
        current = KillSignal.current()
        assert current.path == kill and not current.requested()
    finally:
        if KillSignal.current() is not None:
            KillSignal.current().stop()
        KillSignal._instance = None
