"""EntryEdgeSet: per-linear-segment index of the de Bruijn graph (host
copy of ``gossamer_tpu/graph/entry_edge_set.py``).

Parity with ``src/EntryEdgeSet.{hh,cc}``: entry edges are edges whose
from-node has in-degree != 1 or out-degree != 1
(``EntryEdgeSet.cc:78``); each carries the segment's edge count
(length), the rounded mean multiplicity, and ``endRank`` — the entry
rank of the *reverse complement segment's start edge*
(``EntryEdgeSet.hh:118-124``).

Built vectorized from the segment decomposition (``graph/segments.py``)
instead of the reference's multithreaded linear-path walks (``EntryEdgeSet.cc:154-290``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import u128
from ..io.artifacts import read_array, read_header, write_array, write_header
from ..io.factory import FileFactory
from .graph import Graph
from .kmer_set import rank128
from .segments import decompose

ENTRY_EDGE_SET_VERSION = 2011041901  # src/EntryEdgeSet.hh:23


@dataclass
class EntryEdgeSet:
    k: int
    lo: np.ndarray  # entry edges, sorted (uint64 planes)
    hi: np.ndarray
    counts: np.ndarray  # rounded mean multiplicity per segment
    lengths: np.ndarray  # edges per segment
    end_rank: np.ndarray  # entry rank of the rc segment's start edge
    hist: np.ndarray | None = None  # (mult, freq) written as sidecar

    @property
    def count(self) -> int:
        return len(self.lo)

    @property
    def rho(self) -> int:
        return self.k + 1

    # -- queries (GraphEssentials-compatible surface) ---------------------
    def rank(self, qlo, qhi):
        return rank128(self.lo, self.hi, qlo, qhi)

    def access_and_rank(self, qlo, qhi):
        r = self.rank(qlo, qhi)
        if self.count == 0:
            return np.zeros(np.shape(r), dtype=bool), r
        inside = r < self.count
        safe = np.minimum(r, self.count - 1)
        return inside & (self.lo[safe] == qlo) & (self.hi[safe] == qhi), r

    def select(self, r):
        return self.lo[r], self.hi[r]

    def from_node(self, elo, ehi):
        return u128.shr(elo, ehi, 2)

    def to_node(self, elo, ehi):
        elo = np.asarray(elo, dtype=np.uint64)
        ehi = np.asarray(ehi, dtype=np.uint64)
        if 2 * self.k >= 64:
            return elo.copy(), ehi & np.uint64((1 << (2 * self.k - 64)) - 1)
        return elo & np.uint64((1 << (2 * self.k)) - 1), np.zeros_like(ehi)

    def node_rc(self, nlo, nhi):
        from ..core import kmer as K

        return K.reverse_complement(
            np.asarray(nlo, np.uint64), np.asarray(nhi, np.uint64), self.k
        )

    # -- persistence ------------------------------------------------------
    def write(self, basename: str, fac: FileFactory) -> None:
        name = basename + "-entries"
        write_header(fac, name, {
            "version": ENTRY_EDGE_SET_VERSION, "K": self.k,
            "count": self.count, "kind": "entry-edge-set",
        })
        write_array(fac, name + ".edges-lo", self.lo)
        write_array(fac, name + ".edges-hi", self.hi)
        write_array(fac, name + ".counts", self.counts)
        write_array(fac, name + ".lengths", self.lengths)
        write_array(fac, name + ".ends", self.end_rank)
        # counts histogram sidecar (EntryEdgeSet.cc:247)
        mult, freq = np.unique(self.counts, return_counts=True) if self.count else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        with fac.open_write_text(name + ".counts-hist.txt") as f:
            for m, c in zip(mult, freq):
                f.write(f"{m}\t{c}\n")

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "EntryEdgeSet":
        name = basename + "-entries"
        h = read_header(fac, name, ENTRY_EDGE_SET_VERSION)
        return cls(
            h["K"],
            read_array(fac, name + ".edges-lo"),
            read_array(fac, name + ".edges-hi"),
            read_array(fac, name + ".counts"),
            read_array(fac, name + ".lengths"),
            read_array(fac, name + ".ends"),
        )

    @classmethod
    def build(cls, g: Graph) -> "EntryEdgeSet":
        dec = decompose(g)
        heads = dec.seg_start  # ascending edge ranks = sorted edges
        lo = g.lo[heads]
        hi = g.hi[heads]
        lengths = dec.seg_len.astype(np.int64)
        # rounded mean count per chain (boost::math::round: half away from 0)
        sums = np.zeros(len(heads), dtype=np.float64)
        seg_of = np.searchsorted(dec.seg_off, np.arange(len(dec.order)), side="right") - 1
        np.add.at(sums, seg_of, g.counts[dec.order].astype(np.float64))
        means = np.floor(sums / np.maximum(lengths, 1) + 0.5).astype(np.int64)
        # endRank: entry rank of rc(last edge of chain)
        ends = dec.order[dec.seg_off + dec.seg_len - 1]
        rc_lo, rc_hi = g.edge_rc(g.lo[ends], g.hi[ends])
        end_rank = rank128(lo, hi, rc_lo, rc_hi)
        return cls(g.k, lo, hi, means, lengths, end_rank.astype(np.int64))
