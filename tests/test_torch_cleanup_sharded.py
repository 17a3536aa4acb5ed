"""The port's sharded cleanup passes (``parallel/cleanup_sharded.py``)
against the JAX package on the same graphs (``tests/test_cleanup_sharded.py``'s
seeded reads at k = 11): ``sharded_degrees`` on 8 shards against the JAX
sharded degrees on the 8 virtual CPU devices and on 3 shards against the
JAX host Graph's, the tip candidates, the trim mask and its survivor count
against the JAX sharded trim, and ``prune_tips(mesh=)`` against the JAX
host pass.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gossamer_tpu.algo.cleanup import prune_tips as jax_prune_tips
from gossamer_tpu.graph.build import build_graph
from gossamer_tpu.io.readers import Read
from gossamer_tpu.parallel import cleanup_sharded as JC
from gossamer_tpu_torch.algo.cleanup import prune_tips
from gossamer_tpu_torch.graph.graph import Graph
from gossamer_tpu_torch.parallel import cleanup_sharded as TC
from gossamer_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")


def jax_graph(seed=5, k=11, n_reads=80, read_len=60, glen=500, tips=False):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), glen))
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, glen - read_len))
        r = list(genome[p : p + read_len])
        if tips and i % 7 == 0:  # an error near the end seeds a tip
            q = int(rng.integers(read_len - 6, read_len))
            r[q] = "ACGT"[("ACGT".index(r[q]) + 1) % 4]
        reads.append(Read(f"r{i}".encode(), "".join(r).encode(), None))
    return build_graph(iter(reads), k, chunk=8192)


def port_graph(g) -> Graph:
    return Graph(g.k, np.asarray(g.lo).copy(), np.asarray(g.hi).copy(),
                 np.asarray(g.counts).copy())


def jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("d",))


def test_sharded_degrees_match_jax_sharded():
    g = jax_graph(tips=True)
    out_d, in_d = TC.sharded_degrees(Mesh((CPU,) * 8), g.lo, g.rho)
    want_out, want_in = JC.sharded_degrees(jax_mesh(8), g.lo, g.rho)
    assert np.array_equal(out_d, want_out) and np.array_equal(in_d, want_in)
    assert (in_d == 0).any() and (out_d > 1).any()


@pytest.mark.parametrize("n_dev", [3, 8])
def test_sharded_degrees_match_the_host_graph(n_dev):
    g = jax_graph(seed=n_dev)
    out_d, in_d = TC.sharded_degrees(Mesh((CPU,) * n_dev), g.lo, g.rho)
    flo, fhi = g.from_node(g.lo, g.hi)
    assert np.array_equal(out_d, np.asarray(g.out_degree(flo, fhi)))
    assert np.array_equal(in_d, np.asarray(g.in_degree(flo, fhi)))


def test_sharded_tip_candidates():
    g = jax_graph(seed=9)
    cand = TC.sharded_tip_candidates(Mesh((CPU,) * 8), g.lo, g.rho)
    flo, fhi = g.from_node(g.lo, g.hi)
    assert np.array_equal(cand, np.asarray(g.in_degree(flo, fhi)) == 0)
    assert cand.any()


@pytest.mark.parametrize("cutoff", [2, 3])
def test_sharded_trim_mask_matches_jax_sharded(cutoff):
    g = jax_graph(seed=11)
    keep, kept = TC.sharded_trim_mask(Mesh((CPU,) * 8), g.counts, cutoff)
    want_keep, want_kept = JC.sharded_trim_mask(jax_mesh(8), g.counts, cutoff)
    assert np.array_equal(keep, np.asarray(want_keep)) and kept == want_kept
    assert 0 < kept < g.count


def test_sharded_trim_mask_keeps_no_padding():
    """At cutoff 0 every edge survives and the count is the edges', not the
    padded lanes' (the JAX package counts the padding there)."""
    counts = np.arange(1, 11)
    keep, kept = TC.sharded_trim_mask(Mesh((CPU,) * 4), counts, 0)
    assert keep.all() and kept == 10


def test_shard_planes_pads_the_tail():
    lo = np.arange(10, dtype=np.uint64) * np.uint64(7)
    keys, c, n = TC.shard_planes(lo, np.arange(10), 4)
    assert keys.shape == (4, 3) and n == 10
    assert np.array_equal(keys.reshape(-1)[:10], lo.astype(np.int64))
    assert (keys.reshape(-1)[10:] == (1 << 63) - 1).all()
    assert np.array_equal(c.reshape(-1)[:10], np.arange(10))


@pytest.mark.parametrize("kwargs", [dict(iterations=2),
                                    dict(iterations=3, cutoff=1)])
def test_prune_tips_with_a_mesh_matches_jax(kwargs):
    """The first pass's candidates from the mesh: the JAX host result."""
    g = jax_graph(seed=13, tips=True)
    got = prune_tips(port_graph(g), mesh=Mesh((CPU,) * 4), **kwargs)
    want = jax_prune_tips(g, **kwargs)
    assert np.array_equal(got.lo, np.asarray(want.lo))
    assert np.array_equal(got.counts, np.asarray(want.counts))
    assert got.count < g.count
