"""Contig extraction from a SuperGraph (host copy of
``gossamer_tpu/algo/super_contigs.py``).

Parity with the reference's ``ContigVisitor`` / ``ContigPrinter``
(``src/SuperGraph.cc:40-270``) and ``SuperGraph::printContigs``
(``:729-855``): entailed-path suppression, rc suppression
(`id > rc(id)` skipped), canonical start-edge logic, gap restarts, and
the trailing-K truncation, with all sequence work vectorized over the
graph's segment decomposition.
"""

from __future__ import annotations

import numpy as np

from ..core import kmer as K
from ..graph.graph import Graph
from ..graph.segments import decompose
from ..graph.supergraph import SEG_MASK, SuperGraph, seg_gap, seg_is_gap, seg_is_linear
from .contigs import fmt_double, segment_sequence


class _ChainIndex:
    """entry-edge -> graph chain ranks, built once per print run."""

    def __init__(self, g: Graph):
        self.g = g
        self.dec = decompose(g)
        # head graph-rank -> segment index
        self.head_to_seg = {int(h): i for i, h in enumerate(self.dec.seg_start)}

    def chain(self, elo, ehi) -> np.ndarray:
        g_rank = int(np.atleast_1d(self.g.rank(elo, ehi))[0])
        i = self.head_to_seg[g_rank]
        off = self.dec.seg_off[i]
        return self.dec.order[off : off + self.dec.seg_len[i]]


def path_contig(sg: SuperGraph, g: Graph, ci: _ChainIndex, pid: int):
    """Returns (seq:str, min, max, mean, stddev, seg_lens:[int], seg_starts:[str])."""
    k = g.k
    started = False
    restart = False
    skip = 0
    parts: list[str] = []
    mn, mx, s1, s2, ne = np.iinfo(np.int64).max, 0, 0, 0, 0
    seg_lens: list[int] = []
    seg_starts: list[str] = []
    last_chain = None
    for s in sg.segs[pid]:
        if seg_is_gap(s):
            l = seg_gap(s)
            seg_lens.append(l)
            seg_starts.append(f"{l}g")
            if l > 0:
                parts.append("N" * l)
                skip = 0
            else:
                skip = -l
            restart = True
            continue
        rank = s & SEG_MASK
        seg_lens.append(int(sg.entries.lengths[rank]))
        seg_starts.append(str(rank))
        elo, ehi = sg.entries.select(rank)
        chain = ci.chain(elo, ehi)
        last_chain = chain
        w = g.counts[chain]
        mn = min(mn, int(w.min()))
        mx = max(mx, int(w.max()))
        s1 += int(w.sum())
        s2 += int((w.astype(object) ** 2).sum())
        ne += len(chain)
        seq = segment_sequence(g, chain).tobytes().decode()
        if restart:
            parts.append(seq[skip:])
            restart = False
            started = True
        elif started:
            parts.append(seq[k:])
        else:
            # find the first edge whose from-node allows starting
            j = _first_startable(g, chain)
            if j is not None:
                parts.append(seq[j:])
                started = True
            # else: no output for this chain yet (stats still counted)
    seq = "".join(parts)
    # truncation (ContigVisitor::getTruncatedContig)
    if seq and last_chain is not None:
        last_e = last_chain[-1]
        tlo, thi = g.to_node(g.lo[last_e], g.hi[last_e])
        outd = int(np.atleast_1d(g.out_degree(tlo, thi))[0])
        anti = not bool(np.atleast_1d(g.canonical_node(tlo, thi))[0])
        if not (outd == 0 or anti):
            seq = seq[:-k] if len(seq) >= k else ""
    mean = s1 / ne if ne else 0.0
    std = (np.sqrt(max(ne * s2 - s1 * s1, 0)) / ne) if ne else 0.0
    if mn == np.iinfo(np.int64).max:
        mn = 0
    return seq, mn, mx, mean, std, seg_lens, seg_starts


def _first_startable(g: Graph, chain: np.ndarray) -> int | None:
    flo, fhi = g.from_node(g.lo[chain], g.hi[chain])
    ind = g.in_degree(flo, fhi)
    canon = g.canonical_node(flo, fhi)
    ok = (ind == 0) | canon
    idx = np.nonzero(ok)[0]
    return int(idx[0]) if len(idx) else None


def _entailed_paths(sg: SuperGraph) -> set[int]:
    """Paths whose segment list occurs inside another path's
    (``SuperGraph.cc:741-815`` + ``entails`` at ``:275-301``).

    A contained path must share its FIRST segment with the container, so
    candidates come from a first-segment index instead of comparing all
    pairs sharing any segment (round-2 Weak #4: that was O(paths^2 len));
    identical paths keep the smaller id, mirroring the reference's
    keep-first iteration order."""
    from collections import defaultdict

    ids = sg.path_ids()
    by_seg: dict[int, list[int]] = defaultdict(list)
    for pid in ids:
        for s in set(sg.segs[pid]):
            if not seg_is_gap(s):
                by_seg[s].append(pid)
    entailed: set[int] = set()
    for pid in ids:
        v = sg.segs[pid]
        first = next((s for s in v if not seg_is_gap(s)), None)
        if first is None:
            continue
        for u_pid in by_seg[first]:
            if u_pid == pid:
                continue
            u = sg.segs[u_pid]
            if _entails(u, v) and (len(u) > len(v) or u_pid < pid):
                entailed.add(pid)
                break
    return entailed


def _entails(u: list[int], v: list[int]) -> bool:
    if len(v) > len(u):
        return False
    for i in range(len(u) - len(v) + 1):
        if u[i : i + len(v)] == v:
            return True
    return False


def print_supergraph_contigs(
    sg: SuperGraph,
    g: Graph,
    out,
    *,
    min_length: int = 0,
    omit_sequence: bool = False,
    verbose_headers: bool = False,
    no_line_breaks: bool = False,
    print_entailed: bool = False,
    print_rcs: bool = False,
) -> int:
    ci = _ChainIndex(g)
    entailed = set() if print_entailed else _entailed_paths(sg)
    cols = None if no_line_breaks else 60

    if omit_sequence:
        out.write("Id\tLength\tSegmentLengths\tSegmentStarts\tRevCompId\t"
                  "SuccessorIds\tMinCov\tMaxCov\tMeanCov\tStdDevCov\n")

    n_printed = 0
    for pid in sorted(sg.path_ids()):
        if sg.is_gap(pid):
            continue
        if pid in entailed:
            continue
        if not print_rcs and pid > sg.rc(pid):
            continue
        seq, mn, mx, mean, std, seg_lens, seg_starts = path_contig(sg, g, ci, pid)
        if len(seq) < min_length:
            continue
        n_printed += 1
        rc_id = sg.rc(pid)
        succs = sg.successors(sg.end(pid)) if sg.end(pid) is not None else []
        lens_s = ":".join(str(x) for x in seg_lens)
        starts_s = ":".join(seg_starts)
        succ_s = ":".join(str(x) for x in succs)
        if omit_sequence:
            out.write(
                f"{pid}\t{len(seq)}\t[{lens_s}]\t[{starts_s}]\t{rc_id}\t"
                f"[{succ_s}]\t{mn}\t{mx}\t{fmt_double(mean)}\t{fmt_double(std)}\n"
            )
            continue
        out.write(f">{pid}")
        if verbose_headers:
            out.write(
                f" {len(seq)},[{lens_s}],[{starts_s}],{rc_id},[{succ_s}],"
                f"{mn},{mx},{fmt_double(mean)},{fmt_double(std)}"
            )
        out.write("\n")
        if cols is None:
            out.write(seq + "\n")
        else:
            for j in range(0, len(seq), cols):
                out.write(seq[j : j + cols] + "\n")
    return n_printed
