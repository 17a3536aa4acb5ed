"""The port's scaffolding (``algo/scaffold.py``) and ``cmds/misc.py``.

* The reference's gold fixtures (``tests/data/ref_scaffold``) through the
  port, with the assertions of ``tests/test_ref_parity_scaffold.py``.
* ``build_scaffold`` and ``scaffold`` against the JAX functions on the
  input of ``tests/test_scaffold.py`` (two contigs either side of a dark
  gap, pairs across it): the same links, the same ``-scaf.<lib>`` files,
  the same supergraph after the joins.
* ``merge-graphs`` and ``count-components`` of the port's CLI against the
  JAX CLI's: files and stdout byte-identical.
"""

import io
import os
import random

import numpy as np
import pytest

from gossamer_tpu.algo import scaffold as jscaf
from gossamer_tpu.cli.goss import build_app as jax_app
from gossamer_tpu.graph import entry_edge_set as jees
from gossamer_tpu.graph import graph as jgraph
from gossamer_tpu.graph import supergraph as jsg
from gossamer_tpu.io.factory import StringFileFactory as JFac
from gossamer_tpu.io.readers import Read as JRead
from gossamer_tpu_torch.algo import scaffold as pscaf
from gossamer_tpu_torch.algo.super_contigs import _ChainIndex, path_contig
from gossamer_tpu_torch.cli.goss import main as port_main
from gossamer_tpu_torch.graph import entry_edge_set as pees
from gossamer_tpu_torch.graph import graph as pgraph
from gossamer_tpu_torch.graph import supergraph as psg
from gossamer_tpu_torch.graph.text import restore_graph
from gossamer_tpu_torch.io.factory import StringFileFactory as PFac
from gossamer_tpu_torch.io.readers import Read

import test_ref_parity_scaffold as ref_scaffold
from test_torch_graph import noisy_reads, spectrum

K = 15


@pytest.mark.parametrize("name", ref_scaffold.FIXTURES)
def test_scaffold_gold_parity(name):
    _g, pair_seqs, opts, expected = ref_scaffold._load(name)
    with open(os.path.join(ref_scaffold.DATA, name, "input.dump")) as f:
        g = restore_graph(io.StringIO(f.read()))
    sg = psg.SuperGraph.create(pees.EntryEdgeSet.build(g))
    pairs = [(Read(f"p{i}/1", l.encode()), Read(f"p{i}/2", r.encode()))
             for i, (l, r) in enumerate(pair_seqs)]
    sc = pscaf.build_scaffold(
        sg, g, pairs, orientation="paired-ends",
        insert_size=int(opts["insert_expected_size"]),
        expected_coverage=float(opts["expected_coverage"]),
        min_link_count=int(opts.get("min_link_count", 10)),
        insert_std_dev_pct=float(opts.get("insert_size_std_dev", 10.0)),
        insert_tolerance=float(opts.get("insert_size_tolerance", 2.0)),
        edge_cache_rate=0)
    pscaf.scaffold(sg, [sc], g=g,
                   min_link_count=int(opts.get("min_link_count", 10)))
    ci = _ChainIndex(g)
    got = sorted((path_contig(sg, g, ci, pid)[0],
                  tuple(s if psg.seg_is_gap(s) else (s & psg.SEG_MASK)
                        for s in sg.segs[pid]))
                 for pid in sg.path_ids())
    assert got == sorted(expected), name


# --------------------------------------------------------- against the JAX
def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture(scope="module")
def gap_bridged():
    """tests/test_scaffold.py's input: reads over two flanks of a dark gap,
    pairs with an insert of 240 across it."""
    rng = random.Random(123)
    left, gap, right = rand_seq(rng, 400), rand_seq(rng, 60), rand_seq(rng, 400)
    genome = left + gap + right
    reads = [left[s : s + 60] for s in range(0, len(left) - 60, 7)]
    reads += [right[s : s + 60] for s in range(0, len(right) - 60, 7)]
    L, ins = 50, 240
    r = random.Random(7)
    lhs, rhs = [], []
    for _ in range(120):
        s = r.randrange(len(left) - ins, len(left) + len(gap) - 10)
        s = max(0, min(s, len(genome) - ins))
        frag = genome[s : s + ins]
        lhs.append(frag[:L])
        rhs.append(rc(frag[-L:]))
    codes = np.frombuffer("".join(reads).encode(), np.uint8)
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes)
    lo, hi, c = spectrum(codes.reshape(len(reads), 60).astype(np.uint8), K + 1)
    return lo, hi, c, list(zip(lhs, rhs)), ins


def state(sg):
    return sg.segs, sg.rcs, sg.succ, sg.next_id, sg.count


@pytest.mark.parametrize("rate", [0, 4])
def test_build_scaffold_and_scaffold_match_jax(gap_bridged, rate):
    lo, hi, c, pairs, ins = gap_bridged
    gj = jgraph.Graph(K, lo.copy(), hi.copy(), c.copy())
    gp = pgraph.Graph(K, lo.copy(), hi.copy(), c.copy())
    sj = jsg.SuperGraph.create(jees.EntryEdgeSet.build(gj))
    sp = psg.SuperGraph.create(pees.EntryEdgeSet.build(gp))
    kw = {"insert_size": None if rate else ins, "min_link_count": 5,
          "edge_cache_rate": rate}
    cj = jscaf.build_scaffold(sj, gj, iter([(JRead("a", a.encode()),
                                             JRead("b", b.encode()))
                                            for a, b in pairs]), **kw)
    cp = pscaf.build_scaffold(sp, gp, iter([(Read("a", a.encode()),
                                             Read("b", b.encode()))
                                            for a, b in pairs]), **kw)
    assert cj.links == cp.links and (rate or cp.links)
    assert (cj.insert_size, cj.insert_range) == (cp.insert_size, cp.insert_range)
    fj, fp = JFac(), PFac()
    cj.write("g", 0, fj)
    cp.write("g", 0, fp)
    assert fj.files == fp.files
    back = pscaf.ScaffoldGraph.read("g", 0, fp)
    assert pscaf.ScaffoldGraph.libs("g", fp) == [0]
    assert {k: v[0] for k, v in back.links.items()} == {
        k: v[0] for k, v in cp.links.items()}
    nj = jscaf.scaffold(sj, [cj], g=gj, min_link_count=5)
    np_ = pscaf.scaffold(sp, [cp], g=gp, min_link_count=5)
    assert nj == np_ and (rate or np_ >= 1)
    assert state(sj) == state(sp)


# ------------------------------------------------------------------ the CLIs
def test_merge_graphs_and_count_components_match_jax(tmp_path, capsys):
    for i, seed in enumerate((21, 22)):
        fa = tmp_path / f"r{i}.fa"
        reads = noisy_reads(seed, genome_len=500, n=60)
        fa.write_text("".join(f">r{j}\n{''.join('ACGT'[c] for c in r)}\n"
                              for j, r in enumerate(reads)))
        assert port_main(["build-graph", "-k", str(K), "-I", str(fa), "-O",
                          str(tmp_path / f"g{i}"), "--chunk-size", "4096",
                          "--device", "cpu"]) == 0
    ins = ["-G", str(tmp_path / "g0"), "-G", str(tmp_path / "g1")]
    assert jax_app().main(["merge-graphs", *ins, "-O", str(tmp_path / "m_j")]) == 0
    assert port_main(["merge-graphs", *ins, "-O", str(tmp_path / "m_p"),
                      "--device", "cpu"]) == 0

    def files(stem):
        return {n[len(stem):]: (tmp_path / n).read_bytes()
                for n in os.listdir(tmp_path) if n.startswith(stem + ".")}

    assert files("m_j") == files("m_p") and ".counts" in files("m_p")
    capsys.readouterr()
    for g in ("g0", "m_p"):
        assert jax_app().main(["count-components", "-G", str(tmp_path / g)]) == 0
        want = capsys.readouterr().out
        assert port_main(["count-components", "-G", str(tmp_path / g),
                          "--device", "cpu"]) == 0
        assert capsys.readouterr().out == want and int(want) >= 1
