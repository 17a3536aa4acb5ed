"""Deferred-deletion overlay over a Graph (``src/GraphTrimmer.hh:26``).

Host copy of ``gossamer_tpu/graph/trimmer.py``.  The reference's
GraphTrimmer collects doomed edges in a bitmap and compacts the succinct
structure once.  :class:`TrimView` keeps the original rank space and
answers degree/successor queries *net of the dead bitmap* (a prefix-sum
subtraction — the SparseArrayView originalRank trick,
``src/SparseArrayView.hh:20``), so iterative passes see each other's
deletions and ``finalize()`` performs the single masked compaction.
"""

from __future__ import annotations

import numpy as np

from ..core import u128
from .graph import Graph

U64 = np.uint64


class TrimView:
    """Graph facade with a deletion bitmap; rank space unchanged."""

    def __init__(self, g: Graph):
        self.g = g
        self.dead = np.zeros(g.count, bool)
        self._dp = np.zeros(g.count + 1, np.int64)  # prefix sums of dead
        self._rc = None

    # -- passthrough surface -------------------------------------------
    @property
    def k(self) -> int:
        return self.g.k

    @property
    def rho(self) -> int:
        return self.g.rho

    @property
    def count(self) -> int:  # full rank space (incl. dead slots)
        return self.g.count

    @property
    def lo(self):
        return self.g.lo

    @property
    def hi(self):
        return self.g.hi

    @property
    def counts(self):
        return self.g.counts

    @property
    def live_count(self) -> int:
        return self.g.count - int(self._dp[-1])

    def from_node(self, elo, ehi):
        return self.g.from_node(elo, ehi)

    def to_node(self, elo, ehi):
        return self.g.to_node(elo, ehi)

    def node_rc(self, nlo, nhi):
        return self.g.node_rc(nlo, nhi)

    def begin_end_rank(self, nlo, nhi):
        return self.g.begin_end_rank(nlo, nhi)

    # -- dead-aware queries ---------------------------------------------
    def _live_in(self, r0, r1):
        return (r1 - r0) - (self._dp[r1] - self._dp[r0])

    def out_degree(self, nlo, nhi):
        r0, r1 = self.g.begin_end_rank(nlo, nhi)
        return self._live_in(r0, r1)

    def in_degree(self, nlo, nhi):
        rlo, rhi = self.g.node_rc(nlo, nhi)
        return self.out_degree(rlo, rhi)

    def node_degrees(self, nlo, nhi):
        """Fused dead-aware (out_degree, in_degree): native prefetching
        rank streams net of the deletion-bitmap prefix sums."""
        g = self.g
        nlo = np.asarray(nlo, U64)
        nhi = np.asarray(nhi, U64)
        if (2 * g.rho <= 64 and g.count and not g.hi.any()
                and nlo.ndim == 1 and len(nlo) >= (1 << 14)):
            from ..core import kmer as K
            from ..io.native import native_or_none, native_rank_u64

            b0 = nlo << U64(2)
            rl, _ = K.reverse_complement(nlo, np.zeros_like(nlo), g.k)
            c0 = rl << U64(2)

            def ranks():
                return [native_rank_u64(g.lo, q)
                        for q in (b0, b0 + U64(4), c0, c0 + U64(4))]

            out = native_or_none("dead-aware node degrees", ranks)
            if out is not None:
                rb0, rb1, rc0, rc1 = out
                if 2 * g.rho == 64:  # +4 may wrap for the all-T node
                    rb1 = np.where(b0 + U64(4) < b0, np.int64(g.count), rb1)
                    rc1 = np.where(c0 + U64(4) < c0, np.int64(g.count), rc1)
                return (self._live_in(rb0, rb1), self._live_in(rc0, rc1))
        return self.out_degree(nlo, nhi), self.in_degree(nlo, nhi)

    def edge_rc_rank(self) -> np.ndarray:
        if self._rc is None:
            self._rc = self.g.edge_rc_rank()
        return self._rc

    def successor_table(self):
        """Dead-aware analog of :meth:`Graph.successor_table`: next rank
        along a chain = the unique LIVE out-edge of to(i) when to(i) is
        a live 1-in/1-out node; -1 otherwise (and for dead edges)."""
        g = self.g
        n = g.count
        tlo, thi = g.to_node(g.lo, g.hi)
        blo, bhi = u128.shl(tlo, thi, 2)
        elo_, ehi_ = u128.add_small(blo, bhi, 4)
        r0, r1 = g.rank(blo, bhi), g.rank(elo_, ehi_)
        outd = self._live_in(r0, r1)
        rlo, rhi = g.node_rc(tlo, thi)
        q0, q1 = g.begin_end_rank(rlo, rhi)
        ind = self._live_in(q0, q1)
        through = (outd == 1) & (ind == 1) & ~self.dead
        # first live out-edge within [r0, r1) (degree <= 4)
        nxt = np.full(n, -1, np.int64)
        for j in range(4):
            idx = np.minimum(r0 + j, n - 1)
            hit = (r0 + j < r1) & ~self.dead[idx] & (nxt < 0)
            nxt = np.where(hit, idx, nxt)
        return np.where(through, nxt, -1)

    # -- mutation ---------------------------------------------------------
    def zap(self, mask: np.ndarray) -> int:
        """Mark edges dead; returns newly-dead count."""
        new = mask & ~self.dead
        self.dead |= mask
        np.cumsum(self.dead, out=self._dp[1:])
        return int(new.sum())

    def finalize(self) -> Graph:
        """One masked compaction over all accumulated deletions."""
        return self.g.remove_edges(self.dead)
