"""Graph cleanup: trim-graph and prune-tips (host copy of
``gossamer_tpu/algo/cleanup.py``).

Semantics tracked from ``src/GossCmdTrimGraph.cc`` and
``src/GossCmdPruneTips.cc:69-344``.  The reference walks each in-degree-0
tip sequentially per thread; here tip candidacy, attach-node sibling
coverage checks and zapping are evaluated for *all* tips at once over the
vectorized segment decomposition.

One deliberate deviation: the reference's absolute-cutoff check reads
``c < mRelCutoff.get()`` under the ``cutoff`` gate
(``GossCmdPruneTips.cc:171``) — comparing a coverage against the wrong
option is a latent bug there (inactive in default runs); we implement the
documented intent ``c < cutoff``.
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph
from ..graph.segments import decompose

U64 = np.uint64


def trim_graph(g: Graph, cutoff: int) -> Graph:
    """Drop edges with multiplicity < cutoff (``GossCmdTrimGraph.cc``)."""
    dead = g.counts < cutoff
    return g.remove_edges(dead)


def prune_tips_once(
    view,
    cutoff: int | None = None,
    relative_cutoff: float | None = None,
    start_mask=None,
) -> tuple[int, int]:
    """One prune-tips pass over a :class:`..graph.trimmer.TrimView`; zaps
    into its shared bitmap (``GossCmdPruneTips.cc:241-254``).  Returns
    (tips_removed, edges_zapped).

    ``start_mask``: a per-edge in-degree-0 candidate mask computed
    elsewhere (on a mesh); it must describe the current view (no dead edges
    unaccounted for)."""
    g = view
    n = g.count
    if n == 0 or view.live_count == 0:
        return 0, 0
    dec = decompose(g)
    if len(dec.seg_start) == 0:
        return 0, 0

    heads = dec.seg_start  # chain head edge ranks, ascending
    ends = dec.order[dec.seg_off + dec.seg_len - 1]  # chain end edge ranks
    seg_len = dec.seg_len

    hfrom = g.from_node(g.lo[heads], g.hi[heads])
    beg_out, beg_in = g.node_degrees(*hfrom)
    if start_mask is not None:
        start_ok = start_mask[heads] & ~view.dead[heads]
    else:
        start_ok = (beg_in == 0) & ~view.dead[heads]
    tip_len_ok = seg_len <= 2 * g.k

    tto = g.to_node(g.lo[ends], g.hi[ends])
    end_out, end_in = g.node_degrees(*tto)

    beg_con = beg_out > 1  # (in-degree is 0 for candidates)
    end_con = (end_in > 1) | (end_out > 0)

    joined_end = ~beg_con & end_con
    joined_beg = beg_con & ~end_con
    cand = start_ok & tip_len_ok & (joined_end | joined_beg)

    # attach node + representative coverage per candidate
    c_cov = np.where(joined_end, g.counts[ends], g.counts[heads]).astype(np.int64)
    rc_to = g.node_rc(*tto)
    att_lo = np.where(joined_end, rc_to[0], hfrom[0])
    att_hi = np.where(joined_end, rc_to[1], hfrom[1])

    if cutoff is not None and cutoff > 0:
        cand &= c_cov >= cutoff

    # sibling coverage over the attach node's LIVE out-edges (degree <= 4)
    r0, r1 = g.begin_end_rank(att_lo, att_hi)
    ok = np.ones(len(heads), dtype=bool)
    total = np.zeros(len(heads), dtype=np.int64)
    for j in range(4):
        idx = r0 + j
        safe = np.minimum(idx, n - 1)
        live = (idx < r1) & ~view.dead[safe]
        cov = g.counts[safe].astype(np.int64)
        total += np.where(live, cov, 0)
        ok &= ~(live & (cov < c_cov))
    cand &= ok
    if relative_cutoff is not None and relative_cutoff > 0:
        cand &= ~(c_cov < total * relative_cutoff)

    if not cand.any():
        return 0, 0

    # zap all edges of qualifying chains + their reverse complements
    qualify = np.zeros(n, dtype=bool)
    qualify[heads[cand]] = True
    zap = np.zeros(n, dtype=bool)
    member = qualify[dec.start] & ~dec.cyclic & ~view.dead
    zap[member] = True
    rc_ranks = view.edge_rc_rank()
    zap[rc_ranks[member]] = True

    tips = int(cand.sum())
    zapped = view.zap(zap)
    return tips, zapped


def prune_tips(
    g: Graph,
    iterations: int = 1,
    cutoff: int | None = None,
    relative_cutoff: float | None = None,
    log=None,
    mesh=None,
) -> Graph:
    """Iterated tip pruning with ONE compaction: passes accumulate into
    a shared deletion bitmap (``src/GraphTrimmer.hh:26``; TrimView) and
    the edge array is rewritten once at the end, not per pass.

    With ``mesh``, the first pass's in-degree-0 candidates come from the
    mesh (:func:`..parallel.cleanup_sharded.sharded_tip_candidates`), exact
    there because no edge is dead yet; later passes see deletions and use
    the host view."""
    from ..graph.trimmer import TrimView

    start_mask = None
    if mesh is not None and g.count:
        from ..parallel.cleanup_sharded import sharded_tip_candidates

        start_mask = sharded_tip_candidates(mesh, g.lo, g.rho)
    view = TrimView(g)
    for it in range(iterations):
        tips, zapped = prune_tips_once(
            view, cutoff, relative_cutoff,
            start_mask=start_mask if it == 0 else None)
        if log is not None:
            log("info", f"prune-tips pass {it + 1}: removed {tips} tips ({zapped} edges)")
        if tips == 0:
            break
    return view.finalize()
