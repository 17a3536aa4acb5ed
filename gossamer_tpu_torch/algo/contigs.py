"""Contig extraction from linear segments (host copy of
``gossamer_tpu/algo/contigs.py``).

Output-parity reimplementation of ``printLinearSegments``
(``src/GossCmdPrintContigs.cc:49-196``): same visiting order, same
seen/reverse-complement suppression, same canonical-end length
adjustment, same header stats (C++ ``operator<<`` double formatting
= ``%.6g``) and 60-column FASTA wrap.  The linear-path walks themselves
are replaced by the vectorized decomposition in
:mod:`..graph.segments`.
"""

from __future__ import annotations

import numpy as np

from ..core import kmer as K
from ..graph.graph import Graph
from ..graph.segments import decompose


def fmt_double(x: float) -> str:
    """C++ default ostream formatting for doubles (6 sig digits)."""
    s = f"{x:.6g}"
    return s


def print_contigs(
    g: Graph,
    out,
    *,
    min_length: int = 0,
    min_coverage: int = 0,
    omit_sequence: bool = False,
    verbose_headers: bool = False,
    no_line_breaks: bool = False,
    print_rcs: bool = False,
) -> int:
    """Write contigs; returns number printed."""
    dec = decompose(g)
    rc_rank = g.edge_rc_rank() if g.count else np.zeros(0, dtype=np.int64)
    seen = np.zeros(g.count, dtype=bool)
    cols = None if no_line_breaks else 60

    if omit_sequence:
        out.write("Number\tLength\tMinCov\tMaxCov\tMeanCov\tStdDevCov\n")

    contig_no = 1
    # visit segments in ascending start-edge rank: identical numbering to
    # the reference's rank-order edge scan
    for off, ln, s in sorted(
        zip(dec.seg_off, dec.seg_len, dec.seg_start), key=lambda t: t[2]
    ):
        if seen[s]:
            continue
        ranks = dec.order[off : off + ln]
        seen[s] = True
        seen[rc_rank[ranks[-1]]] = True
        seen[ranks] = True
        if not print_rcs:
            seen[rc_rank[ranks]] = True

        w = g.counts[ranks]
        min_cov = int(w.min())

        first_lo, first_hi = g.select(ranks[0])
        last_lo, last_hi = g.select(ranks[-1])
        fst = g.from_node(first_lo, first_hi)
        lst = g.to_node(last_lo, last_hi)
        in_fst = int(np.atleast_1d(g.in_degree(*fst))[0])
        out_lst = int(np.atleast_1d(g.out_degree(*lst))[0])
        include_fst = in_fst == 0 or bool(np.atleast_1d(g.canonical_node(*fst))[0])
        include_lst = out_lst == 0 or not bool(np.atleast_1d(g.canonical_node(*lst))[0])

        n_edges = len(ranks)
        length = n_edges + g.k
        if length >= g.k and not include_fst:
            length -= g.k
        if length >= g.k and not include_lst:
            length -= g.k

        if length < min_length or min_cov < min_coverage:
            continue

        s_sum = int(w.sum())
        s2 = int((w.astype(object) ** 2).sum()) if len(w) else 0
        mean = s_sum / n_edges
        std = float(np.sqrt(max(s2 / n_edges - mean * mean, 0.0)))
        maximum = int(w.max())

        if omit_sequence:
            out.write(
                f"{contig_no}\t{n_edges + g.k}\t{min_cov}\t{maximum}\t"
                f"{fmt_double(mean)}\t{fmt_double(std)}\n"
            )
            contig_no += 1
            continue

        out.write(f">{contig_no}")
        if verbose_headers:
            out.write(
                f" {n_edges + g.k}:{min_cov}:{maximum}:"
                f"{fmt_double(mean)}:{fmt_double(std)}"
            )
        out.write("\n")
        contig_no += 1

        # sequence = rho bases of first edge + trailing base of each next
        seq = segment_sequence(g, ranks)
        start_off = 0 if include_fst else g.k
        seq = seq[start_off : start_off + length]
        if cols is None:
            out.write(seq.tobytes().decode() + "\n")
        else:
            for j in range(0, len(seq), cols):
                out.write(seq[j : j + cols].tobytes().decode() + "\n")
    return contig_no - 1


def segment_sequence(g: Graph, ranks: np.ndarray) -> np.ndarray:
    """ASCII base array of a chain: first edge's rho bases + each
    subsequent edge's last base (``GossCmdPrintContigs.cc:181-186``)."""
    first = K.kmers_to_strings(g.rho, g.lo[ranks[:1]], g.hi[ranks[:1]])[0]
    if len(ranks) > 1:
        tail_codes = (g.lo[ranks[1:]] & np.uint64(3)).astype(np.int64)
        tail = K.BASE_CHARS[tail_codes]
        return np.concatenate([first, tail])
    return first
