"""The port's mesh walks (``parallel/walk_sharded.py``) against the JAX
package's host passes, which the JAX package's own tests hold
byte-identical to its mesh walks (``tests/test_walk_sharded.py``; those are
not run again here): ``sharded_segment_table`` against ``decompose``,
``sharded_prune_tips_masks`` against ``prune_tips`` under its options,
``decompose_mesh`` and ``pop_bubbles(mesh=)`` against ``decompose`` and
``pop_bubbles``.  Meshes of 3, 4 and 8 shards on the CPU.
"""

import numpy as np
import pytest
import torch

from gossamer_tpu.algo.cleanup import prune_tips as jax_prune_tips
from gossamer_tpu.algo.tour_bus import pop_bubbles as jax_pop_bubbles
from gossamer_tpu.graph.build import build_graph
from gossamer_tpu.graph.segments import decompose as jax_decompose
from gossamer_tpu.io.readers import Read
from gossamer_tpu_torch.algo.tour_bus import pop_bubbles
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.graph.segments import decompose, decompose_mesh
from gossamer_tpu_torch.parallel.mesh import Mesh
from gossamer_tpu_torch.parallel.walk_sharded import (
    sharded_prune_tips_masks, sharded_segment_table)

CPU = torch.device("cpu")


def jax_graph(seed=5, k=11, n_reads=80, read_len=60, glen=500,
              with_tips=True, bubbles=False):
    """``tests/test_walk_sharded.py``'s graphs: reads of a random genome,
    one read in 7 with an error near its end (tips); with ``bubbles`` one
    in 5 also with an error in its middle."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    genome = "".join(rng.choice(list(bases), glen))
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, glen - read_len))
        r = list(genome[p : p + read_len])
        if with_tips and i % 7 == 0:
            q = int(rng.integers(read_len - 6, read_len))
            r[q] = bases[(bases.index(r[q]) + 1) % 4]
        if bubbles and i % 5 == 0:
            q = read_len // 2
            r[q] = bases[(bases.index(r[q]) + 2) % 4]
        reads.append(Read(f"r{i}".encode(), "".join(r).encode(), None))
    return build_graph(iter(reads), k, chunk=8192)


def port_graph(g) -> Graph:
    return Graph(g.k, np.asarray(g.lo).copy(), np.asarray(g.hi).copy(),
                 np.asarray(g.counts).copy())


@pytest.mark.parametrize("n_dev", [3, 8])
def test_sharded_segment_table_matches_decompose(n_dev):
    g = jax_graph(seed=9)
    head, pos, end, lenE, cyclic = sharded_segment_table(
        Mesh((CPU,) * n_dev), g.lo, g.rho)
    dec = jax_decompose(g)
    assert np.array_equal(cyclic, dec.cyclic)
    nc = ~cyclic
    assert np.array_equal(head[nc], dec.start[nc])
    assert np.array_equal(pos[nc], dec.pos[nc])
    ends = dec.order[dec.seg_off + dec.seg_len - 1]
    assert np.array_equal(end[dec.seg_start], ends)
    assert np.array_equal(lenE[dec.seg_start] + 1, dec.seg_len)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(iterations=3),
    dict(cutoff=2),
    dict(relative_cutoff=0.5, iterations=2),
])
def test_sharded_prune_tips_matches_jax_host(kwargs):
    g = jax_graph(seed=13)
    logs = []
    dead = sharded_prune_tips_masks(Mesh((CPU,) * 8), g.lo, np.asarray(g.counts),
                                    g.rho, log=lambda lvl, m: logs.append(m),
                                    **kwargs)
    got = port_graph(g).remove_edges(dead)
    want = jax_prune_tips(g, **kwargs)
    assert np.array_equal(got.lo, np.asarray(want.lo))
    assert np.array_equal(got.counts, np.asarray(want.counts))
    assert all(m.endswith("[mesh]") for m in logs)


def test_sharded_prune_tips_removes_something():
    g = jax_graph(seed=13)
    dead = sharded_prune_tips_masks(Mesh((CPU,) * 4), g.lo, np.asarray(g.counts),
                                    g.rho, iterations=2)
    assert dead.any()


def test_decompose_mesh_equals_decompose():
    g = port_graph(jax_graph(seed=21, bubbles=True))
    want = decompose(g)
    got = decompose_mesh(g, Mesh((CPU,) * 4))
    for name in ("start", "pos", "cyclic", "order", "seg_off", "seg_len",
                 "seg_start"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_pop_bubbles_with_a_mesh_matches_jax():
    g = jax_graph(seed=21, n_reads=160, bubbles=True)
    want, n_want = jax_pop_bubbles(g)
    got, n_got = pop_bubbles(port_graph(g), mesh=Mesh((CPU,) * 4))
    assert n_got == n_want and n_got > 0
    assert np.array_equal(got.lo, np.asarray(want.lo))
    assert np.array_equal(got.counts, np.asarray(want.counts))


def test_empty_graph():
    z = np.zeros(0, np.uint64)
    assert sharded_prune_tips_masks(Mesh((CPU,) * 2), z, z, 12).shape == (0,)
    assert all(len(x) == 0 for x in sharded_segment_table(
        Mesh((CPU,) * 2), z, 12))
