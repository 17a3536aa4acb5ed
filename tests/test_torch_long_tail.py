"""The port's ``cmds/more.py`` (the 11 long-tail ``goss`` commands) against
the JAX CLI: every output file and stdout byte-identical.

Inputs, all seeded:

* the noisy reads of ``tests/test_torch_contigs.py`` counted by the port's
  ``build-graph`` / ``build-kmer-set`` at k = 15 and k = 40, for the graph
  commands (``extract-reads``, ``filter-reads``, ``build-subgraph``,
  ``trim-paths``, ``dot-graph``, ``upgrade-graph``, ``estimate-errors``,
  ``pool-samples``);
* the port's ``gossple`` output of ``tests/test_torch_gossple.py``'s pairs
  (a supergraph and a scaffold library) for ``dot-supergraph``,
  ``build-edge-index`` and ``clip-links``.

Reads with an ``N`` (ROADMAP C.7): the JAX ``extract-reads`` and
``filter-reads`` give the windows after an ``N`` to the next read; the
port takes read ids from the read starts and must emit what a per-read
brute force emits.
"""

import random
import shutil

import numpy as np
import pytest

from gossamer_tpu.cli.goss import main as jax_main
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.graph.kmer_set import KmerSet
from gossamer_tpu_torch.io.factory import PhysicalFileFactory

from test_torch_contigs import files, run_jax, run_port
from test_torch_graph import KS, noisy_reads

FAC = PhysicalFileFactory()


def rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def text(codes) -> str:
    return "".join("ACGT"[c] for c in codes)


def fasta_records(path) -> list[tuple[str, str]]:
    recs = path.read_text().split(">")[1:]
    return [(r.split("\n", 1)[0], "".join(r.split("\n")[1:])) for r in recs]


def windows(seq: str, k: int) -> set[str]:
    """Every N-free k-window of one read."""
    return {seq[i : i + k] for i in range(len(seq) - k + 1)
            if set(seq[i : i + k]) <= set("ACGT")}


def key_strings(k: int, lo, hi) -> set[str]:
    mat = K.kmers_to_strings(k, np.asarray(lo), np.asarray(hi))
    return {row.tobytes().decode() for row in mat}


def brute_extract(reads, g: Graph) -> list[str]:
    """Labels of the reads with a rho-window that is an edge."""
    edges = key_strings(g.rho, g.lo, g.hi)
    return [lbl for lbl, s in reads if windows(s, g.rho) & edges]


def brute_filter(reads, ks: KmerSet) -> list[str]:
    """Labels of the reads with a k-window (either strand) in the set."""
    keys = key_strings(ks.k, ks.lo, ks.hi)
    return [lbl for lbl, s in reads
            if any(w in keys or rc(w) in keys for w in windows(s, ks.k))]


# ------------------------------------------------------------------ inputs
@pytest.fixture(scope="module", params=list(KS))
def built(request, tmp_path_factory):
    """(tmp, graph, k-mer set, query reads FASTA, FASTQ, k)."""
    k = KS[request.param]
    tmp = tmp_path_factory.mktemp(f"tail{k}")
    reads = noisy_reads(41, genome_len=900, n=260, sub_rate=0.008)
    fa = tmp / "reads.fa"
    fa.write_text("".join(f">r{i}\n{text(r)}\n" for i, r in enumerate(reads)))
    g, ks = str(tmp / "g"), str(tmp / "ks")
    run_port(["build-graph", "-k", str(k), "-I", str(fa), "-O", g,
              "--chunk-size", "4096"])
    run_port(["build-kmer-set", "-k", str(k), "-I", str(fa), "-O", ks,
              "--chunk-size", "4096"])
    rng = np.random.default_rng(8)
    query = [text(r) for r in reads[::7]]
    query += [text(rng.integers(0, 4, 80)) for _ in range(20)]
    query += [text(r[:40]) + text(rng.integers(0, 4, 40)) for r in reads[3:60:9]]
    order = rng.permutation(len(query))
    qa, qq = tmp / "q.fa", tmp / "q.fq"
    qa.write_text("".join(f">q{i} x\n{query[i]}\n" for i in order))
    qq.write_text("".join(f"@q{i}\n{query[i]}\n+\n{'I' * len(query[i])}\n"
                          for i in order))
    return tmp, g, ks, qa, qq, k


@pytest.fixture(scope="module")
def asm(tmp_path_factory):
    """Two flanks of a dark gap with pairs across it (the input of
    ``tests/test_scaffold.py``) through the port's ``build-graph -k 15``,
    ``build-entry-edge-set``, ``build-supergraph`` and ``build-scaffold``:
    a supergraph and a scaffold library with links."""
    tmp = tmp_path_factory.mktemp("tailasm")
    rng = random.Random(123)
    left, gap, right = (
        "".join(rng.choice("ACGT") for _ in range(n)) for n in (400, 60, 400))
    genome = left + gap + right
    reads = [left[s : s + 60] for s in range(0, len(left) - 60, 7)]
    reads += [right[s : s + 60] for s in range(0, len(right) - 60, 7)]
    (tmp / "reads.fa").write_text("".join(f">r{i}\n{r}\n"
                                          for i, r in enumerate(reads)))
    with open(tmp / "lhs.fa", "w") as lf, open(tmp / "rhs.fa", "w") as rf:
        for i in range(120):
            s = rng.randrange(len(left) - 240, len(left) + len(gap) - 10)
            frag = genome[s : s + 240]
            lf.write(f">p{i}/1\n{frag[:50]}\n")
            rf.write(f">p{i}/2\n{rc(frag[-50:])}\n")
    base = str(tmp / "p")
    run_port(["build-graph", "-k", "15", "-I", str(tmp / "reads.fa"), "-O",
              base, "--chunk-size", "4096"])
    run_port(["build-entry-edge-set", "-G", base])
    run_port(["build-supergraph", "-G", base])
    run_port(["build-scaffold", "-G", base, "-I", str(tmp / "lhs.fa"), "-I",
              str(tmp / "rhs.fa"), "--insert-expected-size", "240",
              "--min-link-count", "1"])
    return tmp, base


def both_out(tmp, name, args):
    """Run a command writing ``-o`` in both CLIs; the files must agree."""
    oj, op = tmp / f"{name}_j", tmp / f"{name}_p"
    run_jax([*args, "-o", str(oj)])
    run_port([*args, "-o", str(op)])
    assert oj.read_bytes() == op.read_bytes()
    return op


def both_stdout(capsys, args):
    capsys.readouterr()
    run_jax(args)
    want = capsys.readouterr().out
    run_port(args)
    assert capsys.readouterr().out == want
    return want


# ------------------------------------------------------- reads and graphs
@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_extract_reads_matches_jax(built, fmt, capsys):
    tmp, g, _ks, qa, qq, _k = built
    q = qa if fmt == "fa" else qq
    flag = "-I" if fmt == "fa" else "-i"
    out = both_out(tmp, f"extract_{fmt}", ["extract-reads", "-G", g, flag, str(q)])
    graph = Graph.read(g, FAC)
    want = brute_extract(fasta_records(qa), graph)
    if fmt == "fa":
        got = [lbl for lbl, _s in fasta_records(out)]
        assert got == want and 0 < len(want) < len(fasta_records(qa))
    else:
        assert out.read_text().count("\n+\n") == len(want)
    assert both_stdout(capsys, ["extract-reads", "-G", g, flag, str(q)]) == \
        out.read_text()


@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_filter_reads_matches_jax(built, fmt):
    tmp, _g, ks, qa, qq, _k = built
    q = qa if fmt == "fa" else qq
    flag = "-I" if fmt == "fa" else "-i"
    outs = {}
    for stem in ("j", "p"):
        m, n = tmp / f"fm_{fmt}_{stem}", tmp / f"fn_{fmt}_{stem}"
        args = ["filter-reads", "-G", ks, flag, str(q), "--match-file", str(m),
                "--non-match-file", str(n), "--pairs"]
        (run_jax if stem == "j" else run_port)(args)
        outs[stem] = (m.read_bytes(), n.read_bytes())
    assert outs["j"] == outs["p"]
    # one side only
    for side in ("--match-file", "--non-match-file"):
        o = {}
        for stem in ("j", "p"):
            path = tmp / f"f1_{fmt}_{stem}"
            (run_jax if stem == "j" else run_port)(
                ["filter-reads", "-G", ks, flag, str(q), side, str(path)])
            o[stem] = path.read_bytes()
        assert o["j"] == o["p"] == outs["p"][side == "--non-match-file"]
    if fmt == "fa":
        want = brute_filter(fasta_records(qa), KmerSet.read(ks, FAC))
        got = [lbl for lbl, _s in fasta_records(tmp / "fm_fa_p")]
        assert got == want and 0 < len(want) < len(fasta_records(qa))


def test_filter_reads_without_an_output_exits_1(built):
    _tmp, _g, ks, qa, _qq, _k = built
    args = ["filter-reads", "-G", ks, "-I", str(qa)]
    assert jax_main(args) == 1
    assert port_main(args + ["--device", "cpu"]) == 1


C7_GENOME = "GGATCACAGTCTACACTGCTCACTCCAACCCCGGCCCCTG"
C7_CLEAN = ["AGTCCGAGGAGAGGGT", "GCTTCAGAGTATGTAT", "CGGCGGAGGGCACGTC"]


def test_reads_with_n_follow_the_read_starts(tmp_path):
    """Three reads at k = 5: the first holds an N and, after it, a piece of
    the genome; the other two touch nothing.  The JAX CLI gives the
    windows after the N to the second read and emits it; the port emits
    the first, as a per-read brute force does."""
    (tmp_path / "g.fa").write_text(f">g\n{C7_GENOME}\n")
    reads = [("a", C7_CLEAN[0] + "N" + C7_GENOME[5:25]), ("b", C7_CLEAN[1]),
             ("c", C7_CLEAN[2])]
    (tmp_path / "r.fa").write_text("".join(f">{l}\n{s}\n" for l, s in reads))
    g, ks = str(tmp_path / "g"), str(tmp_path / "ks")
    run_port(["build-graph", "-k", "5", "-I", str(tmp_path / "g.fa"), "-O", g,
              "--chunk-size", "4096"])
    run_port(["build-kmer-set", "-k", "5", "-I", str(tmp_path / "g.fa"),
              "-O", ks, "--chunk-size", "4096"])
    want_x = brute_extract(reads, Graph.read(g, FAC))
    want_f = brute_filter(reads, KmerSet.read(ks, FAC))
    assert want_x == want_f == ["a"]
    for stem, main, dev in (("j", jax_main, []), ("p", port_main,
                                                  ["--device", "cpu"])):
        assert main(["extract-reads", "-G", g, "-I", str(tmp_path / "r.fa"),
                     "-o", str(tmp_path / f"x_{stem}"), *dev]) == 0
        assert main(["filter-reads", "-G", ks, "-I", str(tmp_path / "r.fa"),
                     "--match-file", str(tmp_path / f"m_{stem}"),
                     "--non-match-file", str(tmp_path / f"n_{stem}"), *dev]) == 0
    for name in ("x", "m"):
        assert [l for l, _s in fasta_records(tmp_path / f"{name}_j")] == ["b"]
        assert [l for l, _s in fasta_records(tmp_path / f"{name}_p")] == ["a"]
    assert [l for l, _s in fasta_records(tmp_path / "n_p")] == ["b", "c"]


@pytest.mark.parametrize("tag,opts", [
    ("sub0", ["--radius", "0"]), ("sub1", []), ("sub2", ["--radius", "2"]),
    ("sub1l", ["--linear-paths"]), ("sub2l", ["--radius", "2", "--linear-paths"])])
def test_build_subgraph_matches_jax(built, tag, opts):
    tmp, g, _ks, _qa, _qq, _k = built
    seeds = tmp / "seeds.fa"
    seeds.write_text("".join(f">{l}\n{s[:60]}\n"
                             for l, s in fasta_records(tmp / "reads.fa")[:6]))
    args = ["build-subgraph", "-G", g, "-I", str(seeds), *opts]
    run_jax(args + ["-O", str(tmp / f"{tag}_j")])
    run_port(args + ["-O", str(tmp / f"{tag}_p")])
    fp = files(tmp, f"{tag}_p")
    assert files(tmp, f"{tag}_j") == fp
    sub = Graph.read(str(tmp / f"{tag}_p"), FAC)
    assert 0 < sub.count < Graph.read(g, FAC).count


@pytest.mark.parametrize("cutoff", ["2", "6", "100000"])
def test_trim_paths_matches_jax(built, cutoff):
    tmp, g, _ks, _qa, _qq, _k = built
    args = ["trim-paths", "-G", g, "-C", cutoff]
    run_jax(args + ["-O", str(tmp / f"tp{cutoff}_j")])
    run_port(args + ["-O", str(tmp / f"tp{cutoff}_p")])
    fp = files(tmp, f"tp{cutoff}_p")
    assert files(tmp, f"tp{cutoff}_j") == fp
    n = Graph.read(str(tmp / f"tp{cutoff}_p"), FAC).count
    assert n < Graph.read(g, FAC).count and (n == 0) == (cutoff == "100000")


@pytest.mark.parametrize("label", [[], ["--label-edges"]], ids=["plain", "label"])
def test_dot_graph_matches_jax(built, label, capsys):
    tmp, g, _ks, _qa, _qq, _k = built
    sub = str(tmp / "dotsub")
    run_port(["trim-paths", "-G", g, "-C", "6", "-O", sub])
    out = both_out(tmp, f"dot{len(label)}", ["dot-graph", "-G", sub, *label])
    lines = out.read_text().splitlines()
    assert lines[0] == "digraph G {" and lines[-1] == "}"
    assert len(lines) == Graph.read(sub, FAC).count + 2
    assert both_stdout(capsys, ["dot-graph", "-G", sub, *label]) == out.read_text()


def test_upgrade_graph_native_matches_jax(built):
    tmp, g, _ks, _qa, _qq, k = built
    for stem in ("up_j", "up_p"):
        for suffix, data in files(tmp, "g").items():
            (tmp / f"{stem}{suffix}").write_bytes(data)
    run_jax(["upgrade-graph", "-G", str(tmp / "up_j")])
    run_port(["upgrade-graph", "-G", str(tmp / "up_p")])
    assert files(tmp, "up_j") == files(tmp, "up_p") == files(tmp, "g")
    # the reference's format: the narrow graph is written; a wide graph
    # this small needs low bits above 64 and fails in both
    for stem, main, dev in (("up_j", jax_main, []),
                            ("up_p", port_main, ["--device", "cpu"])):
        assert main(["upgrade-graph", "-G", str(tmp / stem), "--format",
                     "reference", *dev]) == (0 if k == 15 else 1)
    assert files(tmp, "up_j") == files(tmp, "up_p")
    if k == 15:
        back = Graph.read(str(tmp / "up_p"), FAC)
        want = Graph.read(g, FAC)
        assert np.array_equal(back.lo, want.lo)
        assert np.array_equal(back.counts, want.counts)


def test_estimate_errors_matches_jax(built, capsys):
    _tmp, g, _ks, _qa, _qq, _k = built
    out = both_stdout(capsys, ["estimate-errors", "-G", g])
    names = [line.split("\t")[0] for line in out.splitlines()]
    assert names == ["estimated-coverage", "error-cutoff",
                     "error-mass-fraction"]


def test_pool_samples_matches_jax(built):
    tmp, _g, ks, qa, _qq, k = built
    other = str(tmp / "qks")
    run_port(["build-kmer-set", "-k", str(k), "-I", str(qa), "-O", other,
              "--chunk-size", "4096"])
    args = ["pool-samples", "-G", ks, "-G", other]
    run_jax(args + ["-O", str(tmp / "pool_j")])
    run_port(args + ["-O", str(tmp / "pool_p")])
    fp = files(tmp, "pool_p")
    assert files(tmp, "pool_j") == fp and ".sample-mask" in fp
    union = KmerSet.read(str(tmp / "pool_p"), FAC)
    both = [KmerSet.read(n, FAC) for n in (ks, other)]
    keys = np.concatenate([np.stack([s.lo, s.hi], 1) for s in both])
    assert union.count == len(np.unique(keys, axis=0)) > both[0].count


# ------------------------------------------------------ supergraph commands
@pytest.mark.parametrize("label", [[], ["--label-edges"]], ids=["plain", "label"])
def test_dot_supergraph_matches_jax(asm, label, capsys):
    tmp, base = asm
    out = both_out(tmp, f"dotsg{len(label)}", ["dot-supergraph", "-G", base,
                                                 *label])
    lines = out.read_text().splitlines()
    assert lines[0] == "digraph SG {" and len(lines) > 3
    assert both_stdout(capsys, ["dot-supergraph", "-G", base, *label]) == \
        out.read_text()


@pytest.mark.parametrize("rate", ["0", "2", "4"])
def test_build_edge_index_matches_jax(asm, rate):
    tmp, base = asm
    for stem in ("ei_j", "ei_p"):
        for suffix, data in files(tmp, "p").items():
            (tmp / f"{stem}{suffix}").write_bytes(data)
    run_jax(["build-edge-index", "-G", str(tmp / "ei_j"), "--edge-cache-rate", rate])
    run_port(["build-edge-index", "-G", str(tmp / "ei_p"), "--edge-cache-rate", rate])
    fp = files(tmp, "ei_p")
    assert files(tmp, "ei_j") == fp
    assert {"-edge-index.header", "-edge-index.edge-seg"} <= set(fp)


def test_estimate_errors_of_the_assembly_matches_jax(asm, capsys):
    _tmp, base = asm
    both_stdout(capsys, ["estimate-errors", "-G", base])


@pytest.mark.parametrize("cutoff", ["1", "33", "34"])
def test_clip_links_matches_jax(asm, cutoff):
    tmp, base = asm
    stems = (f"cl{cutoff}_j", f"cl{cutoff}_p")
    for stem in stems:
        for suffix in (".header", ".links"):
            shutil.copyfile(f"{base}-scaf.0{suffix}",
                            tmp / f"{stem}-scaf.0{suffix}")
    run_jax(["clip-links", "-G", str(tmp / stems[0]), "-C", cutoff])
    run_port(["clip-links", "-G", str(tmp / stems[1]), "-C", cutoff])
    fj, fp = files(tmp, stems[0]), files(tmp, stems[1])
    assert fj == fp
    before = (tmp / "p-scaf.0.links").read_text().splitlines()
    after = fp["-scaf.0.links"].decode().splitlines()
    kept = [l for l in before if int(l.split("\t")[2]) >= int(cutoff)]
    assert after == kept and len(before) == 2
    assert (after == before) == (cutoff != "34")
