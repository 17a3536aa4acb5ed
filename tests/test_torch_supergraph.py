"""The port's entry-edge set, supergraph and supergraph contigs against
the JAX package's, exactly.

The same seeded spectrum (both orientations of reads drawn from a genome
with planted repeats, counted with numpy) is held by a ``Graph`` of each
package at k = 15 (narrow) and k = 40 (wide).  ``EntryEdgeSet.build`` and
``SuperGraph.create`` of each must give byte-identical files (this
package's format and the reference binary's), the reference file set must
read back, linking and erasing must leave the two packages in the same
state, and ``print_supergraph_contigs`` must print the same text with
every flag.  The reference's own supergraph files of the threading gold
fixtures (``tests/data/ref_threading``) must read into the port.
"""

import io
import os

import numpy as np
import pytest

from gossamer_tpu.algo import super_contigs as jsc
from gossamer_tpu.graph import entry_edge_set as jees
from gossamer_tpu.graph import supergraph as jsg
from gossamer_tpu.io.factory import StringFileFactory as JFac
from gossamer_tpu_torch.algo import super_contigs as psc
from gossamer_tpu_torch.graph import entry_edge_set as pees
from gossamer_tpu_torch.graph import supergraph as psg
from gossamer_tpu_torch.graph.text import restore_graph
from gossamer_tpu_torch.io.factory import StringFileFactory as PFac

from test_torch_graph import KS, graph_pair, spectrum

DATA = os.path.join(os.path.dirname(__file__), "data", "ref_threading")
FIXTURES = sorted(os.listdir(DATA))


def repeat_genome(seed: int, unique=120, repeat=50, n_copies=3):
    """Random unique stretches joined by copies of one repeat."""
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, 4, repeat, dtype=np.uint8)
    parts = [rng.integers(0, 4, unique, dtype=np.uint8)]
    for _ in range(n_copies):
        parts += [rep, rng.integers(0, 4, unique, dtype=np.uint8)]
    return np.concatenate(parts)


def tiled_reads(genome: np.ndarray, seed: int, n=220, length=90):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - length, n)
    return np.lib.stride_tricks.sliding_window_view(genome, length)[starts].copy()


def pair(kind: str, seed: int = 3):
    k = KS[kind]
    return graph_pair(*spectrum(tiled_reads(repeat_genome(seed), seed), k + 1), k)


def state(sg):
    return sg.segs, sg.rcs, sg.succ, sg.next_id, sg.count


def written(sg, fac, reference: bool):
    sg.entries.write("g", fac)
    (sg.write_reference if reference else sg.write)("g", fac)
    return dict(fac.files)


@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("reference", [False, True], ids=["ours", "reference"])
def test_entry_edge_set_and_supergraph_files_match_jax(kind, reference):
    gj, gp = pair(kind)
    ej, ep = jees.EntryEdgeSet.build(gj), pees.EntryEdgeSet.build(gp)
    assert ep.count > 8 and ep.count == ej.count
    er = ep.end_rank
    np.testing.assert_array_equal(er[er], np.arange(ep.count))
    sj, sp = jsg.SuperGraph.create(ej), psg.SuperGraph.create(ep)
    assert state(sj) == state(sp)
    fj = written(sj, JFac(), reference)
    fp = written(sp, PFac(), reference)
    assert fj == fp and "g-supergraph.header" in fp


@pytest.mark.parametrize("kind", list(KS))
def test_supergraph_read_round_trips(kind):
    _gj, gp = pair(kind)
    sg = psg.SuperGraph.create(pees.EntryEdgeSet.build(gp))
    for reference in (False, True):
        fac = PFac()
        written(sg, fac, reference)
        assert psg.supergraph_exists("g", fac)
        back = psg.SuperGraph.read("g", fac)
        assert state(back) == state(sg), reference
        np.testing.assert_array_equal(back.entries.end_rank, sg.entries.end_rank)
    fac = PFac()
    sg.write_reference("g", fac)
    back = psg.SuperGraph.read_reference("g", fac, sg.entries)
    assert state(back) == state(sg)


@pytest.mark.parametrize("kind", list(KS))
def test_link_gap_and_erase_match_jax(kind):
    gj, gp = pair(kind)
    sgs = [jsg.SuperGraph.create(jees.EntryEdgeSet.build(gj)),
           psg.SuperGraph.create(pees.EntryEdgeSet.build(gp))]
    before = sgs[1].count
    joined = 0
    for pid in sgs[1].path_ids():
        if sgs[1].is_gap(pid) or not sgs[1].live(pid):
            continue
        succ = sgs[1].successors(sgs[1].end(pid))
        if not succ or succ[0] in (pid, sgs[1].rc(pid)):
            continue
        outs = [sg.link([pid, sg.gap_path(7), succ[0]]) for sg in sgs]
        assert outs[0] == outs[1]
        n_id, n_rc = outs[1]
        assert sgs[1].rc(n_id) == n_rc and sgs[1].rc(n_rc) == n_id
        assert sgs[1].base_size(n_id) == sgs[1].base_size(n_rc)
        for sg in sgs:
            sg.erase(pid)
        joined += 1
        if joined == 3:
            break
    assert joined == 3 and sgs[1].count == before + 3 * (2 + 2 - 2)
    assert state(sgs[0]) == state(sgs[1])
    for sg in sgs:
        sg.erase(n_id)
    assert not sgs[1].live(n_id) and not sgs[1].live(n_rc)
    assert state(sgs[0]) == state(sgs[1])
    # freed ids are reused, in the same order
    assert sgs[0].link([succ[0]]) == sgs[1].link([succ[0]])
    assert state(sgs[0]) == state(sgs[1])


FLAGS = [{}, {"min_length": 60}, {"omit_sequence": True},
         {"verbose_headers": True, "print_rcs": True},
         {"no_line_breaks": True, "print_entailed": True}]


@pytest.mark.parametrize("kind", list(KS))
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(f) or "plain")
def test_print_supergraph_contigs_matches_jax(kind, flags):
    gj, gp = pair(kind)
    sgs = [jsg.SuperGraph.create(jees.EntryEdgeSet.build(gj)),
           psg.SuperGraph.create(pees.EntryEdgeSet.build(gp))]
    pid = next(p for p in sgs[1].path_ids() if sgs[1].successors(sgs[1].end(p)))
    for sg in sgs:  # one joined path with a gap, so entailment and gaps show
        sg.link([pid, sg.gap_path(5), sg.successors(sg.end(pid))[0]])
    out_j, out_p = io.StringIO(), io.StringIO()
    nj = jsc.print_supergraph_contigs(sgs[0], gj, out_j, **flags)
    np_ = psc.print_supergraph_contigs(sgs[1], gp, out_p, **flags)
    assert nj == np_ > 0 and out_j.getvalue() == out_p.getvalue()


@pytest.mark.parametrize("name", FIXTURES)
def test_reference_supergraph_files_read_into_the_port(name):
    d = os.path.join(DATA, name)
    with open(os.path.join(d, "input.dump")) as f:
        g = restore_graph(io.StringIO(f.read()))
    expected = []
    with open(os.path.join(d, "expected.contigs")) as f:
        for line in f:
            if line.strip():
                segs = line.rstrip("\n").partition("\t")[2]
                expected.append(tuple(int(x) for x in segs.split(",")))
    fac = PFac()
    with open(os.path.join(d, "ref.supergraph-files")) as f:
        for line in f:
            _tag, fname, hexdata = line.split()
            fac.files[fname] = bytes.fromhex(hexdata)
    entries = pees.EntryEdgeSet.build(g)
    sg = psg.SuperGraph.read_reference("graph", fac, entries)
    assert sorted(tuple(sg.segs[p]) for p in sg.path_ids()) == sorted(expected)
    fac2 = PFac()
    sg.write_reference("graph", fac2)
    back = psg.SuperGraph.read_reference("graph", fac2, entries)
    assert state(back) == state(sg)
