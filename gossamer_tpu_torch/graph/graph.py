"""The de Bruijn graph: sorted edge array + counts.

The part of ``gossamer_tpu/graph/graph.py`` that build-graph uses:
construction, ``write`` (the same bytes as the JAX package), ``read`` of
this package's own format, ``hist``, ``stat`` and ``lint``.  Edges are
held as sorted ``uint64`` (lo, hi) planes, the replacement for the
reference's succinct ``Graph`` (``src/Graph.hh:62-651``).

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

from .. import GRAPH_VERSION
from ..core import kmer as K
from ..core import u128
from ..io.artifacts import read_array, read_header, write_array, write_header
from ..io.factory import FileFactory
from .kmer_set import rank128

U64 = np.uint64


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
    def write(self, basename: str, fac: FileFactory) -> None:
        counts = self.counts
        if len(counts) == 0 or int(counts.max()) < (1 << 32):
            counts = counts.astype(np.uint32)
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
        mult, freq = self.hist()
        with fac.open_write_text(basename + "-counts-hist.txt") as f:
            for m, c in zip(mult, freq):
                f.write(f"{m}\t{c}\n")

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "Graph":
        h = read_header(fac, basename, GRAPH_VERSION)
        lo = read_array(fac, basename + ".edges-lo")
        if h.get("narrow", 0) or (2 * (h["K"] + 1) <= 64
                                  and not fac.exists(basename + ".edges-hi")):
            hi = np.broadcast_to(U64(0), lo.shape)
        else:
            hi = read_array(fac, basename + ".edges-hi")
        return cls(h["K"], lo, hi, read_array(fac, basename + ".counts"),
                   bool(h.get("asymmetric", 0)))

    # -- queries ---------------------------------------------------------
    def rank(self, qlo, qhi) -> np.ndarray:
        return rank128(self.lo, self.hi, qlo, qhi)

    def edge_rc_rank(self) -> np.ndarray:
        """Rank of each edge's reverse complement (symmetric graphs)."""
        rlo, rhi = K.reverse_complement(np.asarray(self.lo, U64),
                                        np.asarray(self.hi, U64), self.rho)
        return self.rank(rlo, rhi)

    def hist(self):
        """(multiplicities, frequencies) ascending (``Graph::hist``)."""
        if self.count == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        return np.unique(self.counts, return_counts=True)

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
