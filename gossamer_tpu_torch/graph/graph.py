"""The de Bruijn graph: sorted edge array + counts.

Host copy of ``gossamer_tpu/graph/graph.py``: ``write`` gives the same
bytes as the JAX package, ``read`` takes this package's own format and
the reference's binary one (:mod:`..io.reference_format`).  Edges are held as
sorted ``uint64`` (lo, hi) planes, the replacement for the reference's
succinct ``Graph`` (``src/Graph.hh:62-651``); ``rank`` is a vectorized
binary search and ``select`` a gather, so node degrees are two-sided ranks
exactly as in the reference (``beginEndRank``), over whole batches of
nodes.  On narrow graphs the fused degree and successor queries run in
the native library; the numpy forms answer wide graphs, and narrow ones
when the library is unavailable.

Graph invariants preserved (``src/GossCmdLintGraph.cc``):
 * edges sorted strictly ascending;
 * symmetric graphs contain the reverse complement of every edge with the
   same count;
 * header carries {version, K, count, asymmetric}
   (``src/Graph.hh:65-83``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import GRAPH_VERSION
from ..core import kmer as K
from ..core import u128
from ..io.artifacts import read_array, read_header, write_array, write_header
from ..io.factory import FileFactory
from ..utils import profile
from .kmer_set import rank128

U64 = np.uint64


def count_hist(counts: np.ndarray, top: int | None = None):
    """``np.unique(counts, return_counts=True)``: the multiplicities in the
    counts' dtype, ascending, and their frequencies as int64; two empty
    int64 arrays for no counts, as the JAX package gives.  ``top`` is
    ``counts.max()`` where the caller has it.

    Counted, not sorted, where every count lies in ``[0, max(2**16, n))``
    for ``n`` counts and in the signed integer of their width: the bins
    then cost no more than an int64 copy of the counts (``#hist_counted``).
    Any other input is sorted (``#hist_sorted``).
    """
    if len(counts) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if top is None:
        top = int(counts.max())
    kind, signed = counts.dtype.kind, np.dtype(f"i{counts.itemsize}")
    if (kind in "iu" and top < max(1 << 16, len(counts))
            and top <= np.iinfo(signed).max
            and (kind == "u" or int(counts.min()) >= 0)):
        profile.count("hist_counted", 1)
        # torch's bincount reads 32-bit counts as they are, where numpy's
        # first widens them to intp; from_numpy takes no read-only or
        # reversed array
        x = counts.view(signed)
        if not (x.flags.writeable and x.flags.c_contiguous):
            x = x.copy()
        bins = torch.bincount(torch.from_numpy(x)).numpy()
        mult = np.flatnonzero(bins)
        return mult.astype(counts.dtype), bins[mult]
    profile.count("hist_sorted", 1)
    return np.unique(counts, return_counts=True)


@dataclass
class Graph:
    k: int  # node size in bases; edges are (k+1)-mers ("rho-mers")
    lo: np.ndarray  # uint64[n] sorted by (hi, lo)
    hi: np.ndarray
    counts: np.ndarray  # integer multiplicities (u32 for narrow graphs)
    asymmetric: bool = False

    def __post_init__(self):
        # Narrow keys (2*rho <= 64) provably have hi == 0 everywhere:
        # hold it as a zero-stride broadcast view, costing nothing
        # (``src/Graph.hh:62-83``; ~12 B/edge: lo u64 + counts u32).
        if 2 * self.rho <= 64 and getattr(self.hi, "strides", (1,)) != (0,):
            self.hi = np.broadcast_to(U64(0), self.lo.shape)

    @property
    def rho(self) -> int:
        return self.k + 1

    @property
    def count(self) -> int:
        return len(self.lo)

    # -- persistence ----------------------------------------------------
    def write(self, basename: str, fac: FileFactory, hist=None) -> None:
        """The header, the key planes, the counts (uint32 where every count
        is below 2^32) and the histogram sidecar.  ``hist``: the counts'
        ``(mult, freq)`` as :func:`count_hist` gives them, made where the
        counts were (build-graph's finish on the device); the counts are
        then already the file's, and the write reads no max, casts nothing
        and counts nothing."""
        with profile.context("graph/write"):
            counts = self.counts
            if hist is None:
                top = int(counts.max()) if len(counts) else 0
                if top < (1 << 32):
                    counts = counts.astype(np.uint32, copy=False)
            narrow = 2 * self.rho <= 64
            write_header(
                fac,
                basename,
                {
                    "version": GRAPH_VERSION,
                    "K": self.k,
                    "count": self.count,
                    "asymmetric": int(self.asymmetric),
                    "kind": "graph",
                    "narrow": int(narrow),
                },
            )
            write_array(fac, basename + ".edges-lo", self.lo)
            if not narrow:
                write_array(fac, basename + ".edges-hi", self.hi)
            write_array(fac, basename + ".counts", counts)
            # histogram sidecar, reference format: "<multiplicity>\t<freq>\n"
            # ascending (src/Graph.cc:127-134)
            with profile.context("hist"):
                if hist is None:
                    # the file's uint32 counts are the quicker to count;
                    # they are the graph's own unless one of those is
                    # negative
                    if (len(counts) and self.counts.dtype.kind == "i"
                            and int(self.counts.min()) < 0):
                        counts = self.counts
                    hist = count_hist(counts, top)
                mult, freq = hist
                fac.write_text(basename + "-counts-hist.txt", "".join(
                    f"{m}\t{c}\n" for m, c in zip(mult.tolist(), freq.tolist())))

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "Graph":
        try:
            h = read_header(fac, basename, GRAPH_VERSION)
        except (ValueError, UnicodeDecodeError):
            # not our JSON header: try the reference's binary format
            # (interop with graphs built by the original gossamer)
            from ..io.reference_format import (is_reference_graph,
                                               read_reference_graph)

            if is_reference_graph(fac, basename):
                return read_reference_graph(fac, basename)
            raise
        lo = read_array(fac, basename + ".edges-lo")
        if h.get("narrow", 0) or (2 * (h["K"] + 1) <= 64
                                  and not fac.exists(basename + ".edges-hi")):
            hi = np.broadcast_to(U64(0), lo.shape)
        else:
            hi = read_array(fac, basename + ".edges-hi")
        return cls(h["K"], lo, hi, read_array(fac, basename + ".counts"),
                   bool(h.get("asymmetric", 0)))

    # -- basic ops -------------------------------------------------------
    def rank(self, qlo, qhi) -> np.ndarray:
        return rank128(self.lo, self.hi, qlo, qhi)

    def select(self, r):
        return self.lo[r], self.hi[r]

    def access_and_rank(self, qlo, qhi):
        r = self.rank(qlo, qhi)
        if self.count == 0:
            return np.zeros(np.shape(r), dtype=bool), r
        inside = r < self.count
        ridx = np.minimum(r, self.count - 1)
        hit = inside & (self.lo[ridx] == qlo) & (self.hi[ridx] == qhi)
        return hit, r

    def multiplicity(self, r):
        return self.counts[r]

    # -- node helpers (vectorized) --------------------------------------
    def from_node(self, elo, ehi):
        return u128.shr(elo, ehi, 2)

    def to_node(self, elo, ehi):
        k = self.k
        elo = np.asarray(elo, dtype=U64)
        ehi = np.asarray(ehi, dtype=U64)
        if 2 * k >= 64:
            return elo.copy(), ehi & U64((1 << (2 * k - 64)) - 1)
        return elo & U64((1 << (2 * k)) - 1), np.zeros_like(ehi)

    def node_rc(self, nlo, nhi):
        return K.reverse_complement(np.asarray(nlo, U64), np.asarray(nhi, U64), self.k)

    def edge_rc(self, elo, ehi):
        return K.reverse_complement(np.asarray(elo, U64), np.asarray(ehi, U64), self.rho)

    def begin_end_rank(self, nlo, nhi):
        """Out-edge rank range of nodes: [rank(n<<2), rank(n<<2 + 4))."""
        if 2 * self.rho <= 64:
            # narrow: node << 2 fits u64; skip the u128 shift/add planes
            nlo = np.asarray(nlo, U64)
            blo = nlo << U64(2)
            z = np.zeros_like(np.asarray(nhi, U64))
            end = blo + U64(4)
            r1 = self.rank(end, z)
            if self.rho * 2 == 64:  # end may wrap for the all-T node
                r1 = np.where(end < blo, np.int64(self.count), r1)
            return self.rank(blo, z), r1
        blo, bhi = u128.shl(nlo, nhi, 2)
        elo_, ehi_ = u128.add_small(blo, bhi, 4)
        return self.rank(blo, bhi), self.rank(elo_, ehi_)

    def out_degree(self, nlo, nhi):
        r0, r1 = self.begin_end_rank(nlo, nhi)
        return r1 - r0

    def in_degree(self, nlo, nhi):
        """inDegree(n) = outDegree(revcomp(n)) (``GraphEssentials.hh:74-77``)."""
        rlo, rhi = self.node_rc(nlo, nhi)
        return self.out_degree(rlo, rhi)

    def _native_ok(self) -> bool:
        """The native queries take sorted narrow edges (hi == 0 everywhere)."""
        return 2 * self.rho <= 64 and self.count > 0 and not self.hi.any()

    def node_degrees(self, nlo, nhi):
        """Fused (out_degree, in_degree) of a node batch: one native pass
        (4 prefetching rank streams) on narrow graphs; the numpy
        formulation pays ~7 full-array passes on top of the searches."""
        nlo = np.asarray(nlo, U64)
        nhi = np.asarray(nhi, U64)
        if self._native_ok() and nlo.ndim == 1 and len(nlo) >= (1 << 14):
            from ..io.native import native_node_degrees, native_or_none

            out = native_or_none("node degrees", native_node_degrees, self.lo,
                                 self.rho, nlo)
            if out is not None:
                return out
        return self.out_degree(nlo, nhi), self.in_degree(nlo, nhi)

    def canonical_node(self, nlo, nhi):
        clo, chi, flip = K.normalize(np.asarray(nlo, U64), np.asarray(nhi, U64), self.k)
        return ~flip

    # -- structure tables ------------------------------------------------
    def edge_rc_rank(self) -> np.ndarray:
        """Rank of each edge's reverse complement (symmetric graphs)."""
        rlo, rhi = self.edge_rc(self.lo, self.hi)
        return self.rank(rlo, rhi)

    def successor_table(self):
        """For each edge rank i: rank of the unique following edge inside a
        linear segment, or -1 when to(i) is not a 1-in/1-out node.

        This is the vectorized core that replaces the reference's
        sequential ``linearPath`` walks (``src/Graph.tcc:21-46``).
        """
        if self._native_ok():
            from ..io.native import native_or_none, native_successor_table

            nxt = native_or_none("successor table", native_successor_table,
                                 self.lo, self.rho)
            if nxt is not None:
                return nxt
        tlo, thi = self.to_node(self.lo, self.hi)
        outd = self.out_degree(tlo, thi)
        ind = self.in_degree(tlo, thi)
        through = (outd == 1) & (ind == 1)
        blo, bhi = u128.shl(tlo, thi, 2)
        nxt = self.rank(blo, bhi)  # rank of first out-edge of to(i)
        return np.where(through, nxt, -1)

    def hist(self):
        """(multiplicities, frequencies) ascending (``Graph::hist``)."""
        return count_hist(self.counts)

    # -- editing ---------------------------------------------------------
    def remove_edges(self, dead: np.ndarray) -> "Graph":
        """New graph without the flagged edge ranks (``Graph::remove``).

        The reference rewrites the succinct structure through a deletion
        bitmap (``src/GraphTrimmer.cc``); with array storage this is a
        masked compaction.
        """
        keep = ~dead
        return Graph(self.k, self.lo[keep], self.hi[keep], self.counts[keep],
                     self.asymmetric)

    # -- sequence --------------------------------------------------------
    def edge_strings(self, ranks) -> np.ndarray:
        return K.kmers_to_strings(self.rho, self.lo[ranks], self.hi[ranks])

    def stat(self) -> dict:
        """Size/storage property tree (reference ``Graph::stat``,
        ``src/Graph.hh:588-603``)."""
        hi_bytes = 0 if self.hi.strides == (0,) else self.hi.nbytes
        total = int(self.lo.nbytes + hi_bytes + self.counts.nbytes)
        return {
            "K": self.k,
            "count": self.count,
            "asymmetric": self.asymmetric,
            "storage-bytes": total,
            "bits-per-edge": 8.0 * total / max(self.count, 1),
        }

    # -- verification ----------------------------------------------------
    def lint(self) -> list[str]:
        """Structural invariants (``src/GossCmdLintGraph.cc``)."""
        errs = []
        if self.count:
            same = (self.lo[1:] == self.lo[:-1]) & (self.hi[1:] == self.hi[:-1])
            inc = u128.less(self.lo[:-1], self.hi[:-1], self.lo[1:], self.hi[1:])
            if same.any() or not inc.all():
                errs.append("edges not strictly ascending")
            if not self.asymmetric:
                rr = self.edge_rc_rank()
                ok = (rr < self.count)
                if not ok.all():
                    errs.append("missing reverse complement edges")
                else:
                    if not (self.counts[rr] == self.counts).all():
                        errs.append("reverse complement counts differ")
        if (np.asarray(self.counts) <= 0).any():
            errs.append("non-positive edge counts")
        return errs
