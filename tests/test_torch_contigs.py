"""``print-contigs`` and the port's assembler CLI from graph to contigs
against the JAX CLI: every file and stdout byte-identical, at k = 15 and
k = 40.

One graph per k is built by the port (``build-graph --device cpu``; its
files equal the JAX CLI's, ``tests/test_torch_cli.py``) and then goes
through ``trim-graph``, ``prune-tips --iterate 4``, ``pop-bubbles``,
``print-contigs`` with every flag, ``dump-graph``, ``restore-graph``,
``lint-graph`` and ``graph-to-kmer-set`` in both CLIs, and ``print-contigs``
of a supergraph.  Also here: the raises of what cannot run, the
``--device`` default of every command, and that no module of the port
imports JAX or the JAX package.
"""

import ast
import io
import os
import pathlib

import numpy as np
import pytest
import torch

from gossamer_tpu.algo import contigs as jcontigs
from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu_torch.algo import contigs as pcontigs
from gossamer_tpu_torch.cli.goss import build_app as port_app
from gossamer_tpu_torch.cli.goss import main as port_main

from test_torch_graph import KS, graph_pair, noisy_reads, spectrum

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGS = [[], ["--min-length", "60"], ["-C", "3"], ["--no-sequence"],
         ["--verbose-headers"], ["--no-line-breaks"], ["--print-rcs"],
         ["--verbose-headers", "--print-rcs", "--min-length", "45", "-C", "2",
          "--no-line-breaks"]]


def flag_kwargs(flags):
    names = {"--min-length": "min_length", "-C": "min_coverage"}
    switches = {"--no-sequence": "omit_sequence",
                "--verbose-headers": "verbose_headers",
                "--no-line-breaks": "no_line_breaks", "--print-rcs": "print_rcs"}
    kw, it = {}, iter(flags)
    for f in it:
        if f in names:
            kw[names[f]] = int(next(it))
        else:
            kw[switches[f]] = True
    return kw


# ------------------------------------------------------------ the functions
@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "plain")
def test_print_contigs_matches_jax(kind, flags):
    k = KS[kind]
    gj, gp = graph_pair(*spectrum(noisy_reads(31), k + 1), k)
    out_j, out_p = io.StringIO(), io.StringIO()
    nj = jcontigs.print_contigs(gj, out_j, **flag_kwargs(flags))
    np_ = pcontigs.print_contigs(gp, out_p, **flag_kwargs(flags))
    assert nj == np_ and out_j.getvalue() == out_p.getvalue()
    if not flags:
        assert np_ > 3 and out_p.getvalue().startswith(">1\n")


@pytest.mark.parametrize("kind", list(KS))
def test_segment_sequence_and_fmt_double(kind):
    k = KS[kind]
    gj, gp = graph_pair(*spectrum(noisy_reads(31), k + 1), k)
    from gossamer_tpu_torch.graph.segments import decompose

    dec = decompose(gp)
    for i in np.argsort(-dec.seg_len)[:5]:
        ranks = dec.order[dec.seg_off[i] : dec.seg_off[i] + dec.seg_len[i]]
        got = pcontigs.segment_sequence(gp, ranks)
        np.testing.assert_array_equal(got, jcontigs.segment_sequence(gj, ranks))
        assert len(got) == gp.rho + len(ranks) - 1
    for x in (0.0, 1.0, 2.5, 1 / 3, 12345.678, 1e-7, 123456789.0):
        assert pcontigs.fmt_double(x) == jcontigs.fmt_double(x)
    assert pcontigs.fmt_double(1 / 3) == "0.333333"


# ------------------------------------------------------------------ the CLIs
def run_jax(args):
    assert jax_app().main(args) == 0, args


def run_port(args):
    assert port_main(args + ["--device", "cpu"]) == 0, args


def files(tmp, stem):
    """name -> bytes of every file a command wrote for ``stem``."""
    return {n[len(stem):]: (tmp / n).read_bytes() for n in sorted(os.listdir(tmp))
            if n.startswith(stem + ".") or n.startswith(stem + "-")}


@pytest.fixture(scope="module", params=list(KS))
def built(request, tmp_path_factory):
    """(tmp dir, graph base, k): noisy reads counted by the port's CLI."""
    k = KS[request.param]
    tmp = tmp_path_factory.mktemp(f"asm{k}")
    reads = noisy_reads(41, genome_len=900, n=260, sub_rate=0.008)
    fa = tmp / "reads.fa"
    fa.write_text("".join(f">r{i}\n{''.join('ACGT'[c] for c in r)}\n"
                          for i, r in enumerate(reads)))
    g = str(tmp / "g")
    run_port(["build-graph", "-k", str(k), "-I", str(fa), "-O", g,
              "--chunk-size", "4096"])
    return tmp, g, k


def both(tmp, name, args, src, stems=("j", "p")):
    """Run one graph-to-graph command in both CLIs; the files must agree.
    -> the port's output base."""
    outs = [str(tmp / f"{name}_{s}") for s in stems]
    run_jax([*args, "-G", src, "-O", outs[0]])
    run_port([*args, "-G", src, "-O", outs[1]])
    fj, fp = files(tmp, f"{name}_j"), files(tmp, f"{name}_p")
    assert fj == fp and ".header" in fp and ".edges-lo" in fp, name
    return outs[1]


def test_graph_to_contigs_cli_matches_jax(built, capsys):
    tmp, g, k = built
    trimmed = both(tmp, "trim", ["trim-graph", "-C", "2"], g)
    both(tmp, "trimi", ["trim-graph"], g)
    pruned = both(tmp, "prune", ["prune-tips", "--iterate", "4"], trimmed)
    both(tmp, "prunec", ["prune-tips", "-C", "3", "--relative-cutoff", "0.2"],
         trimmed)
    popped = both(tmp, "pop", ["pop-bubbles"], pruned)
    both(tmp, "popc", ["pop-bubbles", "-C", "2", "--relative-cutoff", "0.5",
                       "--max-sequence-length", "60", "--max-edit-distance",
                       "3", "--max-relative-error", "0.3"], pruned)
    sizes = [len(files(tmp, os.path.basename(b))[".counts"])
             for b in (g, trimmed, pruned)]
    assert sizes[0] > sizes[1] >= sizes[2] > 0
    assert k != 15 or sizes[1] > sizes[2]  # the narrow graph has tips to prune
    assert files(tmp, "trimi_p")[".counts"]  # the inferred cutoff left edges
    capsys.readouterr()

    for i, flags in enumerate(FLAGS):
        cj, cp = tmp / f"c{i}_j.fa", tmp / f"c{i}_p.fa"
        run_jax(["print-contigs", "-G", popped, "-o", str(cj), *flags])
        run_port(["print-contigs", "-G", popped, "-o", str(cp), *flags])
        assert cj.read_bytes() == cp.read_bytes(), flags
        assert "-C" in flags or cp.read_bytes() != b"", flags
    # to stdout
    run_jax(["print-contigs", "-G", popped])
    want = capsys.readouterr().out
    run_port(["print-contigs", "-G", popped])
    assert capsys.readouterr().out == want and want.startswith(">1\n")


def test_graph_utilities_cli_match_jax(built):
    tmp, g, k = built
    dj, dp = tmp / "dump_j.txt", tmp / "dump_p.txt"
    run_jax(["dump-graph", "-G", g, "-o", str(dj)])
    run_port(["dump-graph", "-G", g, "-o", str(dp)])
    assert dj.read_bytes() == dp.read_bytes()
    lines = dp.read_text().splitlines()
    assert lines[0] == "#2011101014" and lines[1].split("\t")[0] == str(k)
    run_jax(["restore-graph", "-f", str(dp), "-O", str(tmp / "rest_j")])
    run_port(["restore-graph", "-f", str(dp), "-O", str(tmp / "rest_p")])
    assert files(tmp, "rest_j") == files(tmp, "rest_p") == files(tmp, "g")
    run_jax(["lint-graph", "-G", g])
    run_port(["lint-graph", "-G", g])
    run_jax(["graph-to-kmer-set", "-G", g, "-O", str(tmp / "ks_j")])
    run_port(["graph-to-kmer-set", "-G", g, "-O", str(tmp / "ks_p")])
    ks = files(tmp, "ks_p")
    assert files(tmp, "ks_j") == ks and set(ks) == {".header", ".kmers-lo",
                                                    ".kmers-hi"}
    kj, kp = tmp / "ks_j.txt", tmp / "ks_p.txt"
    run_jax(["dump-kmer-set", "-G", str(tmp / "ks_p"), "-o", str(kj)])
    run_port(["dump-kmer-set", "-G", str(tmp / "ks_p"), "-o", str(kp)])
    assert kj.read_bytes() == kp.read_bytes()
    assert kp.read_text().splitlines()[1].split("\t")[0] == str(k + 1)


def test_lint_graph_reports_a_broken_graph(built, capsys):
    tmp, g, _k = built
    lines = (tmp / "dump_p.txt").read_text().splitlines() if \
        (tmp / "dump_p.txt").exists() else None
    if lines is None:
        run_port(["dump-graph", "-G", g, "-o", str(tmp / "dump_p.txt")])
        lines = (tmp / "dump_p.txt").read_text().splitlines()
    k, count, flags = lines[1].split("\t")
    seq, c = lines[2].split("\t")
    broken = [lines[0], f"{k}\t{count}\t{flags}", f"{seq}\t{int(c) + 1}",
              *lines[3:]]
    (tmp / "broken.txt").write_text("\n".join(broken) + "\n")
    run_port(["restore-graph", "-f", str(tmp / "broken.txt"), "-O",
              str(tmp / "broken")])
    capsys.readouterr()
    assert port_main(["lint-graph", "-G", str(tmp / "broken"),
                      "--device", "cpu"]) == 1
    assert "reverse complement counts differ" in capsys.readouterr().err


# ------------------------------------------- supergraphs and what is not ported
def test_print_contigs_with_a_supergraph_raises(built, capsys):
    """A graph with a supergraph beside it prints supergraph contigs, as the
    JAX CLI does; a supergraph without its entry-edge set raises and
    writes nothing."""
    tmp, g, _k = built
    sg = tmp / "g-supergraph.header"
    sg.write_text("{}")
    try:
        out = tmp / "never.fa"
        assert port_main(["print-contigs", "-G", g, "-o", str(out),
                          "--device", "cpu"]) == 1
        assert "g-entries.header" in capsys.readouterr().err
        assert not out.exists()
    finally:
        sg.unlink()
    popped = str(tmp / "sgc")
    run_port(["trim-graph", "-G", g, "-O", popped, "-C", "2"])
    for args in (["build-entry-edge-set", "-G", popped],
                 ["build-supergraph", "-G", popped]):
        run_jax(args)
        entries = files(tmp, "sgc")
        run_port(args)
        assert files(tmp, "sgc") == entries, args
    for i, flags in enumerate(FLAGS[:5]):
        cj, cp = tmp / f"s{i}_j.fa", tmp / f"s{i}_p.fa"
        run_jax(["print-contigs", "-G", popped, "-o", str(cj), *flags])
        run_port(["print-contigs", "-G", popped, "-o", str(cp), *flags])
        assert cj.read_bytes() == cp.read_bytes() != b"", flags


@pytest.mark.parametrize("cmd", ["trim-graph", "prune-tips", "pop-bubbles"])
def test_cleanup_on_several_devices_raises(built, cmd, capsys, monkeypatch):
    """--num-devices 2 on a machine with one card raises and names the
    cards visible: never a smaller mesh.  On the CPU 2 shards give the one
    device's files."""
    import torch

    tmp, g, _k = built
    out = tmp / f"never_{cmd}"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        assert port_main([cmd, "-G", g, "-O", str(out), "--num-devices", "2",
                          "--device", "cuda"]) == 1
    assert "and 1 are visible" in capsys.readouterr().err
    assert not (tmp / f"never_{cmd}.header").exists()
    run_port([cmd, "-G", g, "-O", str(tmp / f"one_{cmd}"), "--num-devices", "1"])
    run_port([cmd, "-G", g, "-O", str(tmp / f"two_{cmd}"), "--num-devices", "2"])
    assert files(tmp, f"one_{cmd}") == files(tmp, f"two_{cmd}")


# ----------------------------------------------------- the port's own rules
GOSS_ARGS = {
    "build-graph": ["-k", "11", "-I", "x.fa", "-O", "g"],
    "build-kmer-set": ["-k", "11", "-I", "x.fa", "-O", "g"],
    "dump-graph": ["-G", "g"], "dump-kmer-set": ["-G", "g"],
    "restore-graph": ["-f", "x.txt", "-O", "g"], "lint-graph": ["-G", "g"],
    "graph-to-kmer-set": ["-G", "g", "-O", "h"],
    "trim-graph": ["-G", "g", "-O", "h"], "prune-tips": ["-G", "g", "-O", "h"],
    "pop-bubbles": ["-G", "g", "-O", "h"], "print-contigs": ["-G", "g"],
    "annotate-kmers": ["-G", "g", "--annot-list", "a", "--taxonomy", "t"],
    "classify-reads": ["-G", "g", "-I", "x.fa"],
    "build-entry-edge-set": ["-G", "g"], "build-supergraph": ["-G", "g"],
    "thread-reads": ["-G", "g", "-I", "x.fa"],
    "thread-pairs": ["-G", "g", "-I", "x.fa", "-I", "y.fa"],
    "build-scaffold": ["-G", "g", "-I", "x.fa", "-I", "y.fa"],
    "scaffold": ["-G", "g"], "merge-graphs": ["-G", "g", "-G", "h", "-O", "i"],
    "count-components": ["-G", "g"],
    "merge-kmer-sets": ["-G", "g", "-G", "h", "-O", "i"],
    "intersect-kmer-sets": ["-G", "g", "-G", "h", "-O", "i"],
    "subtract-kmer-set": ["-G", "g", "-G", "h", "-O", "i"],
    "merge-and-annotate-kmer-sets": ["-G", "g", "-G", "h", "-O", "i"],
    "compute-near-kmers": ["-G", "g"],
    "extract-reads": ["-G", "g", "-I", "x.fa"],
    "filter-reads": ["-G", "g", "-I", "x.fa", "--match-file", "m"],
    "build-subgraph": ["-G", "g", "-O", "h", "-I", "x.fa"],
    "trim-paths": ["-G", "g", "-O", "h", "-C", "3"], "dot-graph": ["-G", "g"],
    "dot-supergraph": ["-G", "g"], "upgrade-graph": ["-G", "g"],
    "build-edge-index": ["-G", "g"], "estimate-errors": ["-G", "g"],
    "clip-links": ["-G", "g"], "pool-samples": ["-G", "g", "-O", "h"],
    "detect-variants": ["--graph-ref", "g", "--graph-target", "h"],
    "extract-core-genome": ["-G", "g", "-G", "h"],
    "fix-reads": ["-G", "g", "-I", "x.fa"], "build-db": ["-G", "g", "-o", "d"],
}


def test_every_goss_command_is_listed():
    assert sorted(port_app().commands) == sorted(GOSS_ARGS)
    assert set(GOSS_ARGS) == set(jax_app().commands)
    assert len(GOSS_ARGS) == 41


@pytest.mark.parametrize("cmd", sorted(GOSS_ARGS))
def test_goss_commands_default_to_cuda_and_raise_without_it(cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_main([cmd, *GOSS_ARGS[cmd]])


@pytest.mark.parametrize("tool,args", [
    ("xenome", ["index", "-K", "15", "-G", "a.fa", "-H", "b.fa", "-P", "i"]),
    ("xenome", ["classify", "-P", "i", "-I", "r.fa"]),
    ("electus", ["index", "-K", "15", "-I", "a.fa", "-P", "i"]),
    ("electus", ["classify", "-P", "i", "-I", "r.fa"]),
    ("translucent", ["build-graph", "-k", "15", "-I", "r.fa", "-O", "g"]),
    ("translucent", ["trim-relative", "-G", "g", "-O", "h"]),
    ("translucent", ["merge-graph-with-reference", "-G", "g", "--graph-ref",
                     "h", "-O", "i"]),
    ("translucent", ["assemble", "-G", "g", "-I", "r.fa"]),
    ("espresso", ["single", "-I", "r.fa", "-o", "m"]),
    ("espresso", ["query", "-G", "g", "-I", "r.fa"])])
def test_tools_default_to_cuda_and_raise_without_it(tool, args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    main = importlib.import_module(f"gossamer_tpu_torch.cli.{tool}").main
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(args)


def imported_roots(path: pathlib.Path):
    """Top-level names of every absolute import in a source file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_the_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = [*sorted((REPO / "gossamer_tpu_torch").rglob("*.py")),
               REPO / "chip_smoke.py"]
    assert len(sources) > 40
    for path in sources:
        bad = imported_roots(path) & {"jax", "jaxlib", "gossamer_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
