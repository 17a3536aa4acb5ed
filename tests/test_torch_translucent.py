"""The port's ``translucent`` (``cli/translucent.py``) and
``algo/transcripts.py`` against the JAX package's.

* A seeded transcriptome (genes of three exons, each with the isoform that
  skips the middle exon) and paired reads of it: ``translucent
  build-graph``, ``trim-relative``, ``merge-graph-with-reference`` and
  ``assemble`` (two files in lockstep, one interleaved file, three files
  read as one interleaved stream) in both CLIs, every file byte-identical.
* ``assemble_transcripts`` and ``read_edge_ranks`` of each package on the
  same graph, including the two-isoform case of ``tests/test_transcripts.py``.
* Reads with an ``N`` (ROADMAP C.7): the port's ``read_edge_ranks`` of a
  batch equals the same call on each read alone.
"""

import io

import numpy as np
import pytest
import torch

from gossamer_tpu.algo import transcripts as jtx
from gossamer_tpu.cli.goss import build_app as goss_app
from gossamer_tpu.cli.translucent import main as jax_translucent
from gossamer_tpu_torch.algo import transcripts as ptx
from gossamer_tpu_torch.cli.translucent import build_app
from gossamer_tpu_torch.cli.translucent import main as port_translucent
from gossamer_tpu_torch.core import kmer as K
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.io.factory import PhysicalFileFactory

from test_torch_contigs import files
from test_torch_graph import graph_pair, spectrum

K15 = 15
FAC = PhysicalFileFactory()


def text(codes) -> str:
    return "".join("ACGT"[c] for c in codes)


def rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def run_both(tmp, args, out_flag, name):
    """One command in each CLI, ``out_flag`` to ``<name>_j`` / ``<name>_p``."""
    assert jax_translucent([*args, out_flag, str(tmp / f"{name}_j")]) == 0, args
    assert port_translucent([*args, out_flag, str(tmp / f"{name}_p"),
                             "--device", "cpu"]) == 0, args


def transcriptome(rng, n_genes=3):
    """[(isoform with all exons, isoform without the middle one)]."""
    genes = []
    for _ in range(n_genes):
        exons = [text(rng.integers(0, 4, n)) for n in (180, 90, 200)]
        genes.append((exons[0] + exons[1] + exons[2], exons[0] + exons[2]))
    return genes


def pairs_of(rng, isoforms, n_each=60, read_len=50, insert=150):
    out = []
    for t in isoforms:
        for _ in range(n_each):
            s = int(rng.integers(0, len(t) - insert + 1))
            frag = t[s : s + insert]
            out.append((frag[:read_len], rc(frag[-read_len:])))
    return out


@pytest.fixture(scope="module")
def tx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("translucent")
    rng = np.random.default_rng(71)
    genes = transcriptome(rng)
    isoforms = [t for g in genes for t in g]
    pairs = pairs_of(rng, isoforms)
    order = rng.permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    with open(tmp / "r1.fa", "w") as a, open(tmp / "r2.fa", "w") as b, \
            open(tmp / "inter.fa", "w") as c:
        for i, (l, r) in enumerate(pairs):
            a.write(f">p{i}/1\n{l}\n")
            b.write(f">p{i}/2\n{r}\n")
            c.write(f">p{i}/1\n{l}\n>p{i}/2\n{r}\n")
    (tmp / "ref.fa").write_text(f">ref\n{genes[0][0]}\n")
    run_both(tmp, ["build-graph", "-k", str(K15), "-I", str(tmp / "r1.fa"),
                   "-I", str(tmp / "r2.fa"), "--chunk-size", "4096"], "-O", "g")
    assert files(tmp, "g_j") == files(tmp, "g_p")
    return tmp, isoforms


def test_translucent_registers_every_goss_command():
    names = set(build_app().commands)
    assert set(goss_app().commands) | {"trim-relative", "assemble",
                                       "merge-graph-with-reference"} == names
    assert len(names) == 44


@pytest.mark.parametrize("cutoff", ["0.05", "0.3"])
def test_trim_relative_matches_jax(tx, cutoff):
    tmp, _iso = tx
    name = f"tr{cutoff[2:]}"
    run_both(tmp, ["trim-relative", "-G", str(tmp / "g_p"), "--relative-cutoff",
                   cutoff], "-O", name)
    fp = files(tmp, f"{name}_p")
    assert files(tmp, f"{name}_j") == fp
    assert (fp[".counts"] != files(tmp, "g_p")[".counts"]) == (cutoff == "0.3")


def test_merge_graph_with_reference_matches_jax(tx):
    tmp, _iso = tx
    assert port_translucent(["build-graph", "-k", str(K15), "-I",
                             str(tmp / "ref.fa"), "-O", str(tmp / "ref"),
                             "--chunk-size", "4096", "--device", "cpu"]) == 0
    run_both(tmp, ["merge-graph-with-reference", "-G", str(tmp / "ref"),
                   "--graph-ref", str(tmp / "g_p")], "-O", "mg")
    fp = files(tmp, "mg_p")
    assert files(tmp, "mg_j") == fp
    merged, ref = (Graph.read(str(tmp / n), FAC) for n in ("mg_p", "ref"))
    assert 0.9 * ref.count < merged.count <= ref.count
    assert np.isin(merged.lo, ref.lo).all() and merged.counts.max() > 1


@pytest.mark.parametrize("inputs", ["lockstep", "interleaved", "three"])
def test_assemble_matches_jax(tx, inputs):
    tmp, isoforms = tx
    graph = str(tmp / "tr05_p")
    if not (tmp / "tr05_p.header").exists():
        assert port_translucent(["trim-relative", "-G", str(tmp / "g_p"), "-O",
                                 graph, "--device", "cpu"]) == 0
    reads = {"lockstep": ["-I", str(tmp / "r1.fa"), "-I", str(tmp / "r2.fa")],
             "interleaved": ["-I", str(tmp / "inter.fa")],
             "three": ["-I", str(tmp / "inter.fa"), "-I", str(tmp / "r1.fa"),
                       "-I", str(tmp / "r2.fa")]}[inputs]
    run_both(tmp, ["assemble", "-G", graph, *reads, "--min-length", "100"], "-o",
             f"asm_{inputs}")
    got = (tmp / f"asm_{inputs}_p").read_text()
    assert (tmp / f"asm_{inputs}_j").read_text() == got
    seqs = ["".join(r.split("\n")[1:]) for r in got.split(">")[1:]]
    assert seqs and all(any(s in t or s in rc(t) for t in isoforms) for s in seqs)
    assert len(seqs) >= len(isoforms) and max(map(len, seqs)) > 300


# ----------------------------------------------------------- the functions
def tiled_pairs(seq: str, read_len=40, step=5, phase=2):
    """tests/test_transcripts.py's tiled pairs: starts off the shared exon's
    interior, so junction support comes from reads across a junction."""
    reads = [seq[p : p + read_len]
             for p in range(phase, len(seq) - read_len + 1, step)]
    return [(K.encode_bases(reads[i]),
             K.encode_bases(reads[min(i + 2, len(reads) - 1)]))
            for i in range(len(reads))]


@pytest.fixture(scope="module")
def isoform_graphs():
    """Two isoforms sharing a 13 bp exon (the case of
    tests/test_transcripts.py: no 12-mer shared but the exon's interior),
    as a graph of each package at k = 11, and their tiled read pairs."""
    rng = np.random.default_rng(11)
    while True:
        a1, a2, s, b1, b2 = (text(rng.integers(0, 4, n)) for n in (60, 60, 13, 60, 60))
        i1, i2 = a1 + s + b1, a2 + s + b2
        edges = [t[j : j + 12] for t in (i1, i2) for j in range(len(t) - 11)]
        edges += [rc(e) for e in edges]
        if sum(edges.count(e) > 1 for e in set(edges)) <= 4:
            break
    codes = np.stack([K.encode_bases(t) for t in (i1, i2)])
    gj, gp = graph_pair(*spectrum(codes, 12), 11)
    return gj, gp, tiled_pairs(i1) + tiled_pairs(i2), (i1, i2)


def test_assemble_transcripts_matches_jax(isoform_graphs):
    gj, gp, pairs, (i1, i2) = isoform_graphs
    outs = []
    for mod, g in ((jtx, gj), (ptx, gp)):
        out = io.StringIO()
        n = mod.assemble_transcripts(g, iter(pairs), out, min_length=80)
        outs.append((n, out.getvalue()))
    assert outs[0] == outs[1] and outs[1][0] >= 2
    seqs = ["".join(r.split("\n")[1:]) for r in outs[1][1].split(">")[1:]]
    assert any(i1[40:100] in s or rc(i1[40:100]) in s for s in seqs)
    assert any(i2[40:100] in s or rc(i2[40:100]) in s for s in seqs)


def test_read_edge_ranks_and_resolver_match_jax(isoform_graphs):
    gj, gp, pairs, _iso = isoform_graphs
    codes = [c for p in pairs for c in p]
    got, want = ptx.read_edge_ranks(gp, codes), jtx.read_edge_ranks(gj, codes)
    assert len(got) == len(want) == len(codes)
    # the same mapped windows in order; the one window that starts on a
    # read's separator (never mapped) goes to that read in the port, to
    # the next in the JAX package
    for (r1, m1), (r2, m2) in zip(got, want):
        assert np.array_equal(r1[m1], r2[m2]) and m1.any()
    outs = []
    for mod, g, mapped in ((jtx, gj, want), (ptx, gp, got)):
        out = io.StringIO()
        res = mod.ResolveTranscripts("c0", g, out, 50, mappable_reads=len(codes))
        for m in mapped:
            res.add_read(*m)
        outs.append((res.process_component(), out.getvalue()))
    assert outs[0] == outs[1] and "~FPKM=" in outs[1][1]


def test_read_edge_ranks_with_n_follow_the_read_starts(isoform_graphs):
    _gj, gp, pairs, _iso = isoform_graphs
    codes = [c.copy() for p in pairs[:12] for c in p]
    for c in codes[::3]:
        c[len(c) // 2] = 255
    batch = ptx.read_edge_ranks(gp, codes)
    for c, (rnk, maps) in zip(codes, batch):
        alone_r, alone_m = ptx.read_edge_ranks(gp, [c])[0]
        assert np.array_equal(np.nonzero(maps)[0], np.nonzero(alone_m)[0])
        assert np.array_equal(rnk[maps], alone_r[alone_m])
    assert sum(int(m.sum()) for _r, m in batch) > 0


def test_translucent_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_translucent(["assemble", "-G", "g", "-I", "r.fa"])
