"""Graph cleanup passes over a mesh (SURVEY.md section 2.10).

Counterpart of ``gossamer_tpu/parallel/cleanup_sharded.py``.  The cleanup
algorithms' core primitive is degree lookup: rank queries against the
globally sorted edge set.  On the mesh the edges are sharded contiguously
by rank; a query's global rank is the ``psum`` of its per-shard lower
bounds (each shard holds a sorted piece, and lower bounds over a partition
into sorted pieces add up), so degrees come from one ``all_gather`` of the
query block, a local lower bound (``torch.searchsorted``, where the JAX
package sorts queries into the keys) and one ``psum``.  Reference analog:
the per-thread block partitioning of ``GossCmdPruneTips.cc:290-312``.

Narrow keys only (2*rho <= 62): an edge is one int64 key, padded lanes hold
the sentinel 2^63 - 1.

* :func:`sharded_degrees`: (out_degree, in_degree) of every edge's
  from-node.
* :func:`sharded_tip_candidates`: prune-tips pass-1 candidates
  (in-degree-0 from-nodes, ``GossCmdPruneTips.cc:93-97``).
* :func:`sharded_trim_mask`: trim-graph's count >= C survivor mask and the
  global survivor count (``GossCmdTrimGraph.cc``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.canon import rc
from ..ops.fold import SENT
from . import mesh as M


def shard_planes(lo: np.ndarray, counts: np.ndarray | None, n_dev: int):
    """Split sorted uint64 keys into contiguous equal blocks, one per shard,
    padded with the sentinel at the global tail.  -> (keys int64[n_dev, B],
    counts int64[n_dev, B] (0 where padded), n)."""
    n = len(lo)
    B = -(-max(n, 1) // n_dev)
    keys = np.full(n_dev * B, SENT, np.int64)
    keys[:n] = np.asarray(lo, np.uint64).view(np.int64)
    c = np.zeros(n_dev * B, np.int64)
    if counts is not None:
        c[:n] = counts
    return keys.reshape(n_dev, B), c.reshape(n_dev, B), n


def _local_rank(shard_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Lower-bound ranks of the queries in this shard's sorted keys
    (sentinel padding ranks past every real query)."""
    return torch.searchsorted(shard_keys, queries)


def _node_queries(keys: torch.Tensor, is_pad: torch.Tensor, k: int):
    """Edges -> the four rank queries of their from-node f: f<<2, f<<2 + 4,
    rc(f)<<2, rc(f)<<2 + 4 (out-edge and in-edge ranges); sentinel on
    padded lanes."""
    f = torch.where(is_pad, 0, keys >> 2)
    a = f << 2
    c = rc(f, k) << 2
    q = torch.cat([a, a + 4, c, c + 4])
    return torch.where(is_pad.repeat(4), SENT, q)


def _degree_local(mesh: M.Mesh, shards: list[torch.Tensor], k: int):
    """Per-shard body (``make_degree_fn``'s ``local``) -> per local shard
    (out_degree, in_degree) of its edges' from-nodes."""
    B = shards[0].numel()
    pads = [s == SENT for s in shards]
    q = [_node_queries(s, p, k) for s, p in zip(shards, pads)]
    every = M.all_gather(mesh, q)  # everyone answers everyone's queries
    ranks = [_local_rank(s, g.reshape(-1)).view(mesh.size, -1)
             for s, g in zip(shards, every)]
    total = M.psum(mesh, ranks)
    out = []
    for i, (r, p) in enumerate(zip(total, pads)):
        mine = r[mesh.offset + i]
        out_d = torch.where(p, 0, mine[B : 2 * B] - mine[:B])
        in_d = torch.where(p, 0, mine[3 * B :] - mine[2 * B : 3 * B])
        out.append((out_d, in_d))
    return out


def sharded_degrees(mesh: M.Mesh, lo: np.ndarray, rho: int):
    """(out_degree, in_degree) of from(e) for every edge, via the mesh.
    Every process gets the whole result."""
    keys, _c, n = shard_planes(lo, None, mesh.size)
    per = _degree_local(mesh, M.put(mesh, keys), rho - 1)
    out_d = M.gather_rows(mesh, [o for o, _ in per])
    in_d = M.gather_rows(mesh, [i for _, i in per])
    return (torch.cat(out_d).cpu().numpy()[:n],
            torch.cat(in_d).cpu().numpy()[:n])


def sharded_tip_candidates(mesh: M.Mesh, lo: np.ndarray, rho: int):
    """Tip-start candidate mask: edges whose from-node has in-degree 0
    (prune-tips pass 1, ``GossCmdPruneTips.cc:93-97``)."""
    _out_d, in_d = sharded_degrees(mesh, lo, rho)
    return in_d == 0


def sharded_trim_mask(mesh: M.Mesh, counts: np.ndarray, cutoff: int):
    """(keep mask, global survivor count) for trim-graph on the mesh.
    Padded lanes are never kept (the JAX package counts them at a cutoff
    of 0 or less)."""
    n = len(counts)
    B = -(-max(n, 1) // mesh.size)
    c = np.zeros(mesh.size * B, np.int64)
    c[:n] = counts
    real = np.arange(mesh.size * B) < n
    keep = [(x > cutoff - 1) & r for x, r in zip(
        M.put(mesh, c.reshape(mesh.size, B)),
        M.put(mesh, real.reshape(mesh.size, B)))]
    kept = M.psum(mesh, [x.sum() for x in keep])[0]
    mask = torch.cat(M.gather_rows(mesh, keep)).cpu().numpy()[:n]
    return mask, int(kept)
