"""TourBus bubble popping (pop-bubbles; host copy of
``gossamer_tpu/algo/tour_bus.py``).

Faithful reimplementation of ``src/TourBus.cc`` (Velvet-style):

* Pass 1 (``TourBus.cc:366-546``): find branch nodes (out-degree != 1 or
  in-degree != 1 among nodes with out-edges), queue ordered by max
  incoming multiplicity (self-loops excluded), processed highest first.
* Pass 2 (``TourBus.cc:551-643``): per start node, Dijkstra over linear
  segments with time = n_edges / weight(first edge) (``LinearPathInfo``,
  ``TourBus.cc:69-90``), decrease-key work queue, 10000-pass abandon
  guard; on re-join ``analyseEdge`` (``TourBus.cc:797-1078``) walks
  predecessor chains to the common ancestor, composes both sequences and
  gates on max length (2 rho + 2), max edit distance
  (max((2 rho + 27)/27, 2)), max relative error (0.2) and optional
  coverage cutoffs, then trims the minority path (edges + rcs).

The all-segments table (head -> end/length/weight/time) is precomputed
vectorized from the segment decomposition instead of walking
rank/select per step; the per-start-node Dijkstra state is tiny and
stays on host, matching the reference's own locality argument.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..graph.graph import Graph
from ..graph.segments import decompose

MAX_PASSES = 10000


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """O(nm) Levenshtein over base-code arrays (``SmallBaseVector.cc:107``)."""
    n, m = len(a), len(b)
    prev = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        for j in range(1, m + 1):
            cur[j] = min(cur[j - 1] + 1, prev[j] + 1, sub[j - 1])
        prev = cur
    return int(prev[m])


class _SegTable:
    """Per-head-edge segment info, vectorized.

    With ``mesh``, the chain walks (TourBus pass 1's linear-segment
    resolution, ``src/TourBus.cc:366-420``) run on the mesh by pointer
    doubling (:func:`..graph.segments.decompose_mesh`); pass 2's per-start
    Dijkstra stays on the host, as the reference's locality argument has
    it."""

    def __init__(self, g: Graph, mesh=None):
        if mesh is not None:
            from ..graph.segments import decompose_mesh

            dec = decompose_mesh(g, mesh)
        else:
            dec = decompose(g)
        n = g.count
        self.is_head = np.zeros(n, dtype=bool)
        self.is_head[dec.seg_start] = True
        # chains laid out contiguously; map head -> (end, len)
        self.end_of = np.full(n, -1, dtype=np.int64)
        self.len_of = np.zeros(n, dtype=np.int64)
        ends = dec.order[dec.seg_off + dec.seg_len - 1]
        self.end_of[dec.seg_start] = ends
        self.len_of[dec.seg_start] = dec.seg_len
        self.dec = dec
        self.g = g
        # to-node of each chain end
        tlo, thi = g.to_node(g.lo[ends], g.hi[ends])
        self.end_to_lo = np.zeros(n, dtype=np.uint64)
        self.end_to_hi = np.zeros(n, dtype=np.uint64)
        self.end_to_lo[dec.seg_start] = tlo
        self.end_to_hi[dec.seg_start] = thi

    def chain_ranks(self, head: int) -> np.ndarray:
        dec = self.dec
        i = np.searchsorted(dec.seg_start, head)
        off = dec.seg_off[i]
        return dec.order[off : off + dec.seg_len[i]]


def pop_bubbles(
    g: Graph,
    *,
    cutoff: int = 0,
    relative_cutoff: float = 0.0,
    max_sequence_length: int | None = None,
    max_edit_distance: int | None = None,
    max_relative_error: float = 0.2,
    mesh=None,
) -> tuple[Graph, int]:
    """One TourBus pass. Returns (new_graph, bubbles_popped)."""
    rho = g.k + 1
    max_seq = max_sequence_length or (2 * rho + 2)
    max_edit = max_edit_distance or max((2 * rho + 27) // 27, 2)
    n = g.count
    if n == 0:
        return g, 0

    seg = _SegTable(g, mesh)
    deleted = np.zeros(n, dtype=bool)
    rc_rank = g.edge_rc_rank()

    # ---- pass 1: branch nodes + start queue -----------------------------
    flo, fhi = g.from_node(g.lo, g.hi)
    # group boundaries: edges sorted => equal from-nodes adjacent
    new_grp = np.ones(n, dtype=bool)
    if n > 1:
        new_grp[1:] = (flo[1:] != flo[:-1]) | (fhi[1:] != fhi[:-1])
    grp_id = np.cumsum(new_grp) - 1
    n_grp = int(grp_id[-1]) + 1
    grp_first = np.nonzero(new_grp)[0]
    node_lo = flo[grp_first]
    node_hi = fhi[grp_first]
    outd = np.diff(np.append(grp_first, n))
    _, ind = g.node_degrees(node_lo, node_hi)
    branch = (outd != 1) | (ind != 1)

    # max multiplicity among non-self-loop in... out-edges (to(e) != n)
    tlo, thi = g.to_node(g.lo, g.hi)
    not_self = (tlo != flo) | (thi != fhi)
    w = np.where(not_self, g.counts, 0)
    maxmult = np.zeros(n_grp, dtype=np.int64)
    np.maximum.at(maxmult, grp_id, w)

    bsel = np.nonzero(branch)[0]
    # start items ordered by (max multiplicity, node value): group ids
    # ARE node-value order (groups follow the sorted edge array), so the
    # gid replaces the 128-bit node key everywhere below — pass 2 then
    # runs on plain ints (a ~5x wall win at production scale vs Python
    # bigint node keys; same decisions in the same order)
    items = sorted(zip(maxmult[bsel].tolist(), bsel.tolist()))

    # to-node gid of every segment head (vectorized): nodes absent from
    # the from-node table (sinks) get synthetic ids beyond n_grp
    heads_all = seg.dec.seg_start
    h_tlo = seg.end_to_lo[heads_all]
    h_thi = seg.end_to_hi[heads_all]
    if (node_hi == 0).all() and (h_thi == 0).all():
        pos = np.searchsorted(node_lo, h_tlo)
        safe = np.minimum(pos, max(n_grp - 1, 0))
        hitg = (node_lo[safe] == h_tlo) & (node_hi[safe] == h_thi)
    else:
        nk = node_hi.astype(object) * (1 << 64) + node_lo.astype(object)
        hk = h_thi.astype(object) * (1 << 64) + h_tlo.astype(object)
        pos = np.searchsorted(nk, hk)
        safe = np.minimum(pos, max(n_grp - 1, 0))
        hitg = (node_lo[safe] == h_tlo) & (node_hi[safe] == h_thi)
    gids = np.where(hitg, safe, -1)
    if (~hitg).any():
        sink_lo = h_tlo[~hitg]
        sink_hi = h_thi[~hitg]
        _, inv = np.unique(
            np.stack([sink_hi, sink_lo]), axis=1, return_inverse=True)
        gids[~hitg] = n_grp + inv
    head_gid = np.full(n, -1, dtype=np.int64)
    head_gid[heads_all] = gids

    grp_end = grp_first + outd

    stats = {"considered": 0, "popped": 0, "paths": 0}

    # ---- helpers mirroring analyseEdge ----------------------------------
    from_gid = grp_id  # edges are grouped by from-node: rank -> gid

    def compose_sequence(heads: list[int]) -> np.ndarray:
        """k bases of from(first head) + last base of every chain edge."""
        fg = from_gid[heads[0]]
        out = [_node_codes(g, node_lo[fg], node_hi[fg])]
        for h in heads:
            ranks = seg.chain_ranks(h)
            out.append((g.lo[ranks] & np.uint64(3)).astype(np.uint8))
        return np.concatenate(out)

    def chain_cov(heads: list[int]) -> float:
        tot = 0
        length = 0
        for h in heads:
            ranks = seg.chain_ranks(h)
            tot += int(g.counts[ranks].sum())
            length += len(ranks)
        return tot / max(length, 1)

    def analyse_edge(preds: dict, t: int, begin_edge: int) -> None:
        f = int(from_gid[begin_edge])
        maj = preds.get(t)
        if maj is None:
            if f == t:
                return
            preds[t] = begin_edge
            return
        stats["considered"] += 1
        # minority chain node set from f upwards
        minority = set()
        nk = f
        minority.add(nk)
        while nk in preds:
            nk = int(from_gid[preds[nk]])
            if nk in minority:
                break
            minority.add(nk)
        # majority walk up to common ancestor
        anc = int(from_gid[maj])
        while anc not in minority:
            e = preds.get(anc)
            if e is None:  # reference asserts; be safe instead
                return
            anc = int(from_gid[e])
        # compose minority edge list ancestor -> join
        def walk_back(edge0: int) -> list[int] | None:
            lst = [edge0]
            e2 = edge0
            guard = 0
            while True:
                k2 = int(from_gid[e2])
                if k2 == anc:
                    return lst
                e2 = preds.get(k2)
                if e2 is None or guard > MAX_PASSES:
                    return None
                lst.insert(0, e2)
                guard += 1

        min_heads = walk_back(begin_edge)
        if min_heads is None:
            return
        min_seq = compose_sequence(min_heads)
        if len(min_seq) > max_seq:
            return
        maj_heads = walk_back(maj)
        if maj_heads is None:
            return
        maj_seq = compose_sequence(maj_heads)
        if len(maj_seq) > max_seq:
            return
        if abs(len(maj_seq) - len(min_seq)) > max_edit:
            return
        ed = edit_distance(maj_seq, min_seq)
        if ed > max_edit:
            return
        if ed / max(len(min_seq), len(maj_seq)) > max_relative_error:
            return
        if cutoff > 0 or relative_cutoff > 0:
            min_cov = chain_cov(min_heads)
            if cutoff > 0 and min_cov < cutoff:
                return
            if relative_cutoff > 0:
                maj_cov = chain_cov(maj_heads)
                if min_cov < maj_cov * relative_cutoff:
                    return
        stats["popped"] += 1
        for h in min_heads:
            ranks = seg.chain_ranks(h)
            deleted[ranks] = True
            deleted[rc_rank[ranks]] = True
            stats["paths"] += 1

    # ---- pass 2: Dijkstra per start node (highest multiplicity first) ----
    len_of = seg.len_of
    counts = g.counts
    for _mult, nk in reversed(items):
        preds: dict[int, int] = {}
        dist: dict[int, float] = {nk: 0.0}
        heap: list[tuple[float, int, int]] = [(0.0, nk, 0)]
        passes = 0
        while heap:
            time, cur, d = heapq.heappop(heap)
            if time > dist.get(cur, float("inf")) + 1e-12:
                continue  # stale entry (decrease-key emulation)
            passes += 1
            if passes > MAX_PASSES:
                break
            if cur >= n_grp:
                continue  # synthetic sink gid: no out-edges
            # doNode: each non-deleted out-edge's linear segment
            for head in range(grp_first[cur], grp_end[cur]):
                if deleted[head]:
                    continue
                length = int(len_of[head])
                if length <= 1:
                    continue  # single-edge segments skipped (TourBus.cc:698)
                t = int(head_gid[head])
                weight = int(counts[head])
                etime = length / max(weight, 1)
                ttime = time + etime
                tdist = d + length
                if preds.get(t) == head:
                    continue  # loop
                if tdist > 2 * max_seq:
                    continue
                if t not in dist:
                    dist[t] = ttime
                    heapq.heappush(heap, (ttime, t, tdist))
                    preds[t] = head
                elif dist[t] > ttime:
                    old = preds[t]
                    dist[t] = ttime
                    heapq.heappush(heap, (ttime, t, tdist))
                    analyse_edge(preds, t, old)
                    preds[t] = head
                elif dist[t] == time:
                    # reference: ``destTime == pOriginTime &&
                    # isOnPredecessorChain(...)`` (``TourBus.cc:775``);
                    # isOnPredecessorChain is stubbed ``return true``
                    # (``TourBus.cc:787-791`` — "a conservative
                    # approximation"), so the compiled reference always
                    # skips here.  NOTE the comparison is against the
                    # *origin* time, not the new total time: an
                    # equal-TOTAL-time tie (dist[t] == ttime) falls
                    # through to analyse_edge below, exactly as the
                    # reference does on uniform-coverage bubbles.
                    continue
                else:
                    analyse_edge(preds, t, head)

    g2 = g.remove_edges(deleted)
    return g2, stats["popped"]


def _node_codes(g: Graph, lo, hi) -> np.ndarray:
    """k base codes of a node, most significant first."""
    k = g.k
    v = (int(np.asarray(hi).item()) << 64) | int(np.asarray(lo).item())
    return np.array([(v >> (2 * (k - 1 - i))) & 3 for i in range(k)], dtype=np.uint8)
