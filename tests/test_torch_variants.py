"""The port's ``cmds/variants.py`` and ``algo/fix_reads.py`` against the
JAX package's.

* ``detect-variants`` and ``extract-core-genome`` of graphs the port's
  ``build-graph`` counted from a seeded genome and its variants, at k = 15
  and k = 40: files and stdout byte-identical, the variant edges equal a
  brute force over edge strings.
* ``FixReadsEngine`` of each package on the same graph (a seeded genome's
  noisy reads, counted and cut at 2), read for read over reads with
  substitutions, error bursts, an ``N`` and no anchor; then ``fix-reads``
  of both CLIs, FASTA and FASTQ in, byte-identical.  Wide graphs raise in
  both.
* ``build-db`` of both CLIs on a supergraph: every table equal row by row.
"""

import sqlite3

import numpy as np
import pytest

from gossamer_tpu.algo.fix_reads import FixReadsEngine as JEngine
from gossamer_tpu.cli.goss import main as jax_main
from gossamer_tpu_torch.algo.fix_reads import FixReadsEngine
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.io.factory import PhysicalFileFactory

from test_torch_contigs import run_jax, run_port
from test_torch_graph import KS, graph_pair, spectrum
from test_torch_long_tail import asm, both_stdout, key_strings  # noqa: F401  (asm: a fixture)

FAC = PhysicalFileFactory()


def text(codes) -> str:
    return "".join("ACGT"[c] for c in codes)


# ------------------------------------------------ detect-variants, core genome
@pytest.fixture(scope="module", params=list(KS))
def variant_graphs(request, tmp_path_factory):
    """(tmp, k, {name: graph base}): a genome, a variant of it (three
    substitutions, a 5 bp insertion) and an unrelated genome."""
    k = KS[request.param]
    tmp = tmp_path_factory.mktemp(f"var{k}")
    rng = np.random.default_rng(62)
    ref = rng.integers(0, 4, 400, dtype=np.uint8)
    tgt = ref.copy()
    tgt[[90, 200, 310]] = (tgt[[90, 200, 310]] + 1) % 4
    tgt = np.concatenate([tgt[:250], rng.integers(0, 4, 5, dtype=np.uint8),
                          tgt[250:]])
    other = rng.integers(0, 4, 300, dtype=np.uint8)
    bases = {}
    for name, codes in (("ref", ref), ("tgt", tgt), ("other", other)):
        (tmp / f"{name}.fa").write_text(f">{name}\n{text(codes)}\n")
        bases[name] = str(tmp / name)
        run_port(["build-graph", "-k", str(k), "-I", str(tmp / f"{name}.fa"),
                  "-O", bases[name], "--chunk-size", "4096"])
    return tmp, k, bases


def test_detect_variants_matches_jax_and_brute_force(variant_graphs, capsys):
    tmp, k, b = variant_graphs
    args = ["detect-variants", "--graph-ref", b["ref"], "--graph-target", b["tgt"]]
    oj, op = tmp / "var_j.txt", tmp / "var_p.txt"
    run_jax(args + ["-o", str(oj)])
    run_port(args + ["-o", str(op)])
    assert oj.read_bytes() == op.read_bytes()
    assert both_stdout(capsys, args) == op.read_text()
    g, h = Graph.read(b["ref"], FAC), Graph.read(b["tgt"], FAC)
    ref_edges = key_strings(g.rho, g.lo, g.hi)
    ref_nodes = {e[:k] for e in ref_edges}
    mat = K.kmers_to_strings(h.rho, h.lo, np.asarray(h.hi))
    counts = {row.tobytes().decode(): int(c) for row, c in zip(mat, h.counts)}
    want = sorted(e for e in counts if e not in ref_edges and e[:k] in ref_nodes)
    got = [line.split("\t") for line in op.read_text().splitlines()]
    assert sorted(s for s, _c in got) == want and len(want) >= 8
    assert all(int(c) == counts[s] for s, c in got)


def test_extract_core_genome_matches_jax(variant_graphs, capsys):
    _tmp, _k, b = variant_graphs
    out = both_stdout(capsys, ["extract-core-genome", "-G", b["ref"], "-G",
                               b["tgt"], "-G", b["other"]])
    d = {tuple(line.split("\t")[:2]): float(line.split("\t")[2])
         for line in out.splitlines()}
    assert len(d) == 3 and d[(b["ref"], b["tgt"])] < d[(b["ref"], b["other"])]


# ------------------------------------------------------------------ fix-reads
@pytest.fixture(scope="module")
def fix_inputs():
    """(genome, JAX graph, port graph, query reads): a 1.2 kbp genome's
    noisy reads counted at k = 15 and cut at 2; reads of the genome with
    substitutions, bursts, an N, and random reads."""
    k = 15
    rng = np.random.default_rng(63)
    genome = rng.integers(0, 4, 1200, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - 80, 200)
    reads = np.lib.stride_tricks.sliding_window_view(genome, 80)[starts].copy()
    sub = rng.random(reads.shape) < 0.005
    reads[sub] = (reads[sub] + 1) % 4
    lo, hi, c = spectrum(reads, k + 1)
    keep = c >= 2
    gj, gp = graph_pair(lo[keep], hi[keep], c[keep], k)
    queries = []
    for i in range(40):
        s = int(rng.integers(0, len(genome) - 100))
        q = genome[s : s + 100].copy()
        n_err = i % 5
        if i % 7 == 3:  # a burst of three
            q[40:43] = (q[40:43] + 1) % 4
        pos = rng.integers(0, 100, n_err)
        q[pos] = (q[pos] + rng.integers(1, 4, n_err)) % 4
        seq = text(q)
        if i % 11 == 5:
            seq = seq[:60] + "N" + seq[61:]
        if i % 3 == 1:
            seq = seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        queries.append(seq)
    queries += [text(rng.integers(0, 4, 90)) for _ in range(4)]
    return genome, gj, gp, queries


def test_fix_reads_engine_matches_jax_read_for_read(fix_inputs):
    _genome, gj, gp, queries = fix_inputs
    ej, ep = JEngine(gj), FixReadsEngine(gp)
    assert ep.lo_k == ej.lo_k and ep.followers == ej.followers
    n_fixed = 0
    for q in queries:
        got, want = ep.fix_read(q.encode()), ej.fix_read(q.encode())
        assert got == want, q
        n_fixed += got[1] > 0
    assert n_fixed >= 30


@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_fix_reads_cli_matches_jax(fix_inputs, tmp_path, fmt):
    genome, _gj, gp, queries = fix_inputs
    gp.write(str(tmp_path / "g"), FAC)
    if fmt == "fa":
        (tmp_path / "q").write_text("".join(f">q{i} d\n{q}\n"
                                            for i, q in enumerate(queries)))
    else:
        (tmp_path / "q").write_text("".join(f"@q{i}\n{q}\n+\n{'I' * len(q)}\n"
                                            for i, q in enumerate(queries)))
    args = ["fix-reads", "-G", str(tmp_path / "g"),
            "-I" if fmt == "fa" else "-i", str(tmp_path / "q")]
    run_jax(args + ["-o", str(tmp_path / "j.fa")])
    run_port(args + ["-o", str(tmp_path / "p.fa")])
    out = (tmp_path / "p.fa").read_text()
    assert (tmp_path / "j.fa").read_text() == out
    g = text(genome)
    fixed = out.splitlines()[1::2]
    whole = sum(s in g or s.translate(str.maketrans("ACGT", "TGCA"))[::-1] in g
                for s in fixed)
    assert len(fixed) == len(queries) and whole >= 20


def test_fix_reads_on_a_wide_graph_exits_1(variant_graphs, tmp_path):
    _tmp, k, b = variant_graphs
    (tmp_path / "r.fa").write_text(">r\nACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTAC\n")
    args = ["fix-reads", "-G", b["ref"], "-I", str(tmp_path / "r.fa"), "-o",
            str(tmp_path / "x.fa")]
    want = 0 if k == 15 else 1
    assert jax_main(args) == want
    assert port_main(args + ["--device", "cpu"]) == want


# ------------------------------------------------------------------- build-db
def tables(path) -> dict:
    con = sqlite3.connect(path)
    try:
        names = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {n: (con.execute(f"SELECT sql FROM sqlite_master WHERE name='{n}'")
                    .fetchone()[0],
                    con.execute(f"SELECT * FROM {n} ORDER BY rowid").fetchall())
                for n in names}
    finally:
        con.close()


def test_build_db_matches_jax_by_table_rows(asm, tmp_path):  # noqa: F811
    _tmp, base = asm
    run_jax(["build-db", "-G", base, "-o", str(tmp_path / "j.db")])
    run_port(["build-db", "-G", base, "-o", str(tmp_path / "p.db")])
    got = tables(tmp_path / "p.db")
    assert got == tables(tmp_path / "j.db")
    assert set(got) == {"version", "nodes", "links", "sequences", "alignments"}
    from gossamer_tpu_torch.graph.supergraph import SuperGraph

    sg = SuperGraph.read(base, FAC)
    paths = [p for p in sg.path_ids() if not sg.is_gap(p)]
    assert len(got["nodes"][1]) == len(paths) > 0
    assert all(len(seq) == row[3] for (_i, seq), row in
               zip(got["sequences"][1], got["nodes"][1]))


def test_build_db_without_a_supergraph_exits_1(variant_graphs, tmp_path):
    _tmp, _k, b = variant_graphs
    args = ["build-db", "-G", b["ref"], "-o", str(tmp_path / "x.db")]
    assert jax_main(args) == 1
    assert port_main(args + ["--device", "cpu"]) == 1
