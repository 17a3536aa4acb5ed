"""Scaffolding: pair-library links between superpaths with gap estimates
(host copy of ``gossamer_tpu/algo/scaffold.py``).

Functional counterpart of ``src/GossCmdBuildScaffold.cc`` +
``src/GossCmdScaffold.cc`` + ``src/ScaffoldGraph.{hh,cc}``: build-scaffold
maps a pair library onto a graph over SuperPathIds whose edges carry
(gap estimate, support count, gap range); scaffold linearizes each
component with the reference's placement algorithm —

1. rc-merge the scaffold graph (``ScaffoldGraph::mergeRcs``,
   ``ScaffoldGraph.cc:634-724``);
2. per component: order nodes by a support-priority BFS from a terminal
   (``linearise``, ``GossCmdScaffold.cc:437-506``);
3. place each node nearest its predecessor subject to the placed
   neighbours' gap windows (``placeNear``/``calculateBounds``,
   ``GossCmdScaffold.cc:312-382``), then 5 relaxation sweeps to window
   midpoints (``placeMid``, ``GossCmdScaffold.cc:399-414,557-564``);
4. resolve overlapping placements by 7-mer end alignment
   (``alignEnds``, ``GossCmdScaffold.cc:141-215,570-599``);
5. emit each chain as gap-joined superpaths (``GossCmdScaffold.cc:743-779``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

from ..graph.graph import Graph
from ..graph.supergraph import SuperGraph
from ..io.factory import FileFactory
from ..io.readers import Read
from .threading import PathIndex, UniquenessCache, collect_pair_links


SCAF_VERSION = 2012032701  # src/ScaffoldGraph.hh:63
ORIENTATIONS = ["paired-ends", "mate-pairs", "innies", "outies"]
# PairLinker::Orientation { PairedEnds, MatePairs, Innies, Outies }


class ScaffoldGraph:
    """links: (a, b) -> [count, gap, range].

    Persisted in the REFERENCE's ``-scaf.N`` format
    (``src/ScaffoldGraph.cc:120-196``): a raw binary
    ``{u64 version, u64 insertSize, u64 insertRange, u32 orientation}``
    header plus a text ``.links`` file of ``lhs\\trhs\\tcount\\tgap``
    lines — libraries are numbered 0.. and discovered by scanning
    (``ScaffoldGraph.cc:436-462``)."""

    def __init__(self, insert_size: int, links: dict | None = None,
                 insert_range: int | None = None,
                 orientation: str = "paired-ends"):
        self.insert_size = insert_size
        self.insert_range = (insert_range if insert_range is not None
                             else 2 * insert_size // 5)
        self.orientation = orientation
        self.links: dict[tuple[int, int], list[int]] = links or {}

    def write(self, basename: str, lib: int, fac: FileFactory) -> None:
        import struct

        name = f"{basename}-scaf.{int(lib)}"
        orient = ORIENTATIONS.index(self.orientation) \
            if self.orientation in ORIENTATIONS else 0
        with fac.open_write(name + ".header") as f:
            f.write(struct.pack("<QQQI4x", SCAF_VERSION, self.insert_size,
                                self.insert_range, orient))
        # links hold [count, gap_sum, rng] in memory; the reference's
        # file line carries the per-link mean gap (ScaffoldGraph.cc:176)
        lines = [f"{a}\t{b}\t{v[0]}\t{v[1] // max(v[0], 1)}\n"
                 for (a, b), v in sorted(self.links.items())]
        fac.write_text(name + ".links", "".join(lines))

    @classmethod
    def read(cls, basename: str, lib: int, fac: FileFactory) -> "ScaffoldGraph":
        import struct

        name = f"{basename}-scaf.{int(lib)}"
        with fac.open_read(name + ".header") as f:
            hdr = f.read()
        version, ins, rng, orient = struct.unpack_from("<QQQI", hdr, 0)
        if version != SCAF_VERSION:
            from ..io.artifacts import VersionMismatch

            raise VersionMismatch(name, version, SCAF_VERSION)
        links = {}
        for line in fac.read_text(name + ".links").splitlines():
            if not line.strip():
                continue
            a, b, c, g = line.split("\t")
            links[(int(a), int(b))] = [int(c), int(g) * int(c), rng]
        return cls(ins, links, insert_range=rng,
                   orientation=ORIENTATIONS[orient]
                   if orient < len(ORIENTATIONS) else "paired-ends")

    @staticmethod
    def exists_any(basename: str, fac: FileFactory) -> bool:
        return fac.exists(basename + "-scaf.0.header")

    @staticmethod
    def libs(basename: str, fac: FileFactory) -> list[int]:
        """Scan -scaf.N library numbers (``ScaffoldGraph.cc:436-449``)."""
        out = []
        n = 0
        while fac.exists(f"{basename}-scaf.{n}.header"):
            out.append(n)
            n += 1
        return out

    @staticmethod
    def next_lib(basename: str, fac: FileFactory) -> int:
        return len(ScaffoldGraph.libs(basename, fac))

    @staticmethod
    def remove_all(basename: str, fac: FileFactory) -> None:
        for lib in ScaffoldGraph.libs(basename, fac):
            fac.remove(f"{basename}-scaf.{lib}.header")
            fac.remove(f"{basename}-scaf.{lib}.links")


def build_scaffold(
    sg: SuperGraph,
    g: Graph,
    pairs: Iterable[tuple[Read, Read]],
    *,
    orientation: str = "paired-ends",
    insert_size: int | None = None,
    expected_coverage: float | None = None,
    min_link_count: int = 10,
    insert_std_dev_pct: float = 10.0,
    insert_tolerance: float = 2.0,
    edge_cache_rate: int = 0,
    log=None,
) -> ScaffoldGraph:
    from .coverage import estimate_coverage

    if expected_coverage is None:
        mult, freq = g.hist()
        expected_coverage = estimate_coverage(mult, freq)
    idx = PathIndex(g, sg, edge_cache_rate)
    ucache = UniquenessCache(sg, expected_coverage)
    links, dist_hist = collect_pair_links(pairs, idx, ucache, sg, g.rho, orientation)
    if insert_size is None:
        if dist_hist:
            items = sorted(dist_hist.items())
            total = sum(c for _, c in items)
            acc = 0
            insert_size = items[-1][0]
            for d, c in items:
                acc += c
                if 2 * acc >= total:
                    insert_size = d
                    break
        else:
            insert_size = 250
        if log:
            log("info", f"estimated insert size = {insert_size}")
    out: dict[tuple[int, int], list[int]] = {}
    k = g.k
    # gap window = the library's insert spread: insertRange = 2 * dev
    # (``GossCmdBuildScaffold.cc:424-427``; edges carry it as get<3>,
    # placement bounds use half of it)
    rng = int(2 * insert_tolerance * (insert_std_dev_pct / 100.0)
              * insert_size)
    for (a, b), (cnt, l_sum, r_sum) in links.items():
        if cnt < min_link_count:
            continue
        lhs_off = l_sum // cnt
        rhs_off = r_sum // cnt
        init_len = (sg.size(a) + k - lhs_off) + rhs_off
        gap = insert_size - init_len
        out[(a, b)] = [cnt, gap * cnt, rng]
    return ScaffoldGraph(insert_size, out)


class _Scaf:
    """Merged rc-folded scaffold adjacency: edge = (other, gap, count, rng).

    ``links`` values are [count, gap, rng] with the gap already averaged
    (output of :func:`_merge_rcs`)."""

    def __init__(self, links: dict[tuple[int, int], list[int]]):
        self.tos: dict[int, list] = defaultdict(list)
        self.froms: dict[int, list] = defaultdict(list)
        for (a, b), (c, gap, rng) in links.items():
            self.tos[a].append((b, gap, c, rng))
            self.froms[b].append((a, gap, c, rng))

    def nodes(self) -> set[int]:
        return set(self.tos) | set(self.froms)

    def component(self, seed: int) -> set[int]:
        out = {seed}
        stack = [seed]
        while stack:
            n = stack.pop()
            for e in self.tos.get(n, []) + self.froms.get(n, []):
                if e[0] not in out:
                    out.add(e[0])
                    stack.append(e[0])
        return out


def _merge_rcs(sg: SuperGraph, links: dict) -> dict:
    """Fold each edge's rc mirror into one orientation per component
    (``ScaffoldGraph::mergeRcs``, ``ScaffoldGraph.cc:634-724``).

    Each physical contig appears in at most one orientation: pick an
    orientation per contig by constraint propagation (an edge written
    (a, b) says "a and b are co-oriented as written"); a component with
    contradictory constraints is self-mirrored and is left unmerged,
    exactly as the reference skips such components."""
    out: dict[tuple[int, int], list[int]] = {}

    def merge_edge(a, b, gap, c, rng):
        key = (a, b)
        if key in out:
            v = out[key]
            v[1] = (v[1] * v[0] + gap * c) // (v[0] + c)
            v[0] += c
            v[2] = max(v[2], rng)
        else:
            out[key] = [c, gap, rng]

    def contig(n: int) -> int:
        return min(n, sg.rc(n))

    def pol(n: int) -> int:
        return 0 if n == contig(n) else 1

    nbr_edges: dict[int, list] = defaultdict(list)
    for e in links:
        a, b = e
        nbr_edges[contig(a)].append(e)
        nbr_edges[contig(b)].append(e)

    assigned: dict[int, int] = {}  # contig -> chosen polarity
    done_contigs: set[int] = set()
    for seed in sorted(nbr_edges):
        if seed in done_contigs:
            continue
        # BFS with polarity propagation
        comp_edges: set = set()
        comp: set[int] = {seed}
        assigned[seed] = 0
        stack = [seed]
        consistent = True
        while stack:
            cn = stack.pop()
            for e in nbr_edges[cn]:
                comp_edges.add(e)
                a, b = e
                ca, cb = contig(a), contig(b)
                rel = pol(a) ^ pol(b)  # 0: co-oriented as canonical
                for x, other in ((ca, cb), (cb, ca)):
                    if x in assigned and other not in assigned:
                        assigned[other] = assigned[x] ^ rel
                        comp.add(other)
                        stack.append(other)
                if ca in assigned and cb in assigned:
                    if assigned[ca] ^ assigned[cb] != rel:
                        consistent = False
        done_contigs |= comp
        if not consistent:
            # self-mirrored component: leave its edges as-is
            for e in comp_edges:
                c, gsum, rng = links[e]
                merge_edge(e[0], e[1], gsum // c, c, rng)
            continue
        for (a, b) in comp_edges:
            c, gsum, rng = links[(a, b)]
            gap = gsum // c
            if assigned[contig(a)] == pol(a):
                merge_edge(a, b, gap, c, rng)
            else:
                merge_edge(sg.rc(b), sg.rc(a), gap, c, rng)
    # drop self-edges introduced by palindromic paths
    return {(a, b): v for (a, b), v in out.items() if a != b}


def _calculate_bounds(sg, sc: _Scaf, dist: dict, n: int):
    """Position window for n given placed neighbours
    (``GossCmdScaffold.cc:312-357``)."""
    node_size = sg.base_size(n)
    lo, hi = None, None
    for (f, gap, c, rng) in sc.froms.get(n, []):
        if f in dist:
            edge_pos = dist[f] + sg.base_size(f) + gap
            half = rng // 2
            lo = edge_pos - half if lo is None else max(lo, edge_pos - half)
            hi = edge_pos + half if hi is None else min(hi, edge_pos + half)
    for (t, gap, c, rng) in sc.tos.get(n, []):
        if t in dist:
            edge_pos = dist[t] - (gap + node_size)
            half = rng // 2
            lo = edge_pos - half if lo is None else max(lo, edge_pos - half)
            hi = edge_pos + half if hi is None else min(hi, edge_pos + half)
    return lo, hi


def _align_ends(a_seq: str, b_seq: str, est: int):
    """Best overlap alignment of end(a) with start(b) by 7-mer votes
    (``GossCmdScaffold.cc:141-215``).  Returns aln (negative overlap) or
    None."""
    K = 7
    len_a = len(a_seq)
    ofs: dict[str, list[int]] = defaultdict(list)
    for i in range(len_a - K + 1):
        w = a_seq[i : i + K]
        if "N" not in w:
            ofs[w].append(i - len_a)
    alns: dict[int, int] = defaultdict(int)
    for i in range(len(b_seq) - K + 1):
        w = b_seq[i : i + K]
        for of in ofs.get(w, ()):
            alns[of - i] += 1
    good = {a: h for a, h in alns.items() if h >= (-a - K + 1) // 2}
    if not good:
        return None
    return min(good, key=lambda a: abs(a - est))


def _linearise(sg, g, sc: _Scaf, avail: set):
    """One component -> position multimap (``GossCmdScaffold.cc:437-610``)."""
    import heapq

    start = None
    for n in sorted(avail):
        if not any(t in avail for (t, *_r) in sc.tos.get(n, [])):
            continue
        if any(f in avail for (f, *_r) in sc.froms.get(n, [])):
            continue
        start = n
        break
    if start is None:
        return None

    ord_: dict[int, int] = {start: 0}
    heap: list = []
    ctr = 0

    def enqueue(n, pos):
        nonlocal ctr
        for (f, gap, c, rng) in sc.froms.get(n, []):
            if f not in ord_:
                heapq.heappush(heap, (-c, ctr, f,
                                      pos - gap - sg.base_size(f)))
                ctr += 1
        end_pos = pos + sg.base_size(n)
        for (t, gap, c, rng) in sc.tos.get(n, []):
            if t not in ord_:
                heapq.heappush(heap, (-c, ctr, t, end_pos + gap))
                ctr += 1

    enqueue(start, 0)
    while heap:
        _negc, _t, n, d = heapq.heappop(heap)
        if n not in ord_ and sg.rc(n) not in ord_ and n in avail:
            ord_[n] = d
            enqueue(n, d)

    # place in distance order, nearest to the running end
    ds: dict[int, int] = {}
    items = sorted(ord_.items(), key=lambda kv: (kv[1], kv[0]))
    first_n, first_x = items[0]
    ds[first_n] = first_x
    end = first_x + sg.base_size(first_n)
    for n, _x in items[1:]:
        lo, hi = _calculate_bounds(sg, sc, ds, n)
        if lo is None:  # unconstrained
            continue
        if lo > hi:  # unplaceable
            continue
        pos = min(max(end, lo), hi)
        ds[n] = pos
        end = pos + sg.base_size(n)

    # relax to window midpoints
    for _ in range(5):
        for n in list(ds):
            lo, hi = _calculate_bounds(sg, sc, ds, n)
            if lo is not None and lo <= hi:
                ds[n] = (lo + hi) // 2

    # overlap alignment of consecutive placements
    placed = sorted(ds.items(), key=lambda kv: (kv[1], kv[0]))
    if len(placed) >= 2 and g is not None:
        from .super_contigs import _ChainIndex, path_contig

        ci = _ChainIndex(g)
        k = g.k

        def seq_of(pid):
            return path_contig(sg, g, ci, pid)[0]

        move = 0
        out = []
        for i in range(len(placed) - 1):
            n, x = placed[i]
            nn, nx = placed[i + 1]
            out.append((n, x + move))
            cur_end = x + sg.base_size(n)
            est_gap = nx - cur_end
            if est_gap < 0:
                a_seq = seq_of(n)[-k:]
                b_seq = seq_of(nn)[:k]
                aln = _align_ends(a_seq, b_seq, est_gap)
                if aln is None or aln < -k:
                    move += -est_gap  # abut
                else:
                    move += aln - est_gap
        n, x = placed[-1]
        out.append((n, x + move))
        placed = sorted(out, key=lambda kv: (kv[1], kv[0]))
    return placed


def scaffold(
    sg: SuperGraph,
    scafs: list[ScaffoldGraph],
    *,
    g: Graph | None = None,
    min_link_count: int = 10,
    max_gap: int = 10000,
    log=None,
) -> int:
    """Linearize scaffold links into gap-joined superpaths
    (``GossCmdScaffold::operator()``, ``GossCmdScaffold.cc:612-786``)."""
    merged: dict[tuple[int, int], list[int]] = {}
    for sc in scafs:
        for l, (c, gsum, rng) in sc.links.items():
            if l in merged:
                v = merged[l]
                v[0] += c
                v[1] += gsum
                v[2] = max(v[2], rng)
            else:
                merged[l] = [c, gsum, rng]
    merged = {(a, b): v for (a, b), v in merged.items()
              if v[0] >= min_link_count and a != b
              and sg.live(a) and sg.live(b)}
    merged = _merge_rcs(sg, merged)
    sc = _Scaf(merged)

    joins = 0
    left = sc.nodes()
    while left:
        placed = _linearise(sg, g, sc, left)
        if placed is None:
            break
        for n, _x in placed:
            left.discard(n)
            left.discard(sg.rc(n))
        if len(placed) < 2:
            continue
        cur, cur_x = placed[0]
        cur_end = cur_x + sg.base_size(cur)
        n_chain = 1
        for nxt, nxt_x in placed[1:]:
            if not (sg.live(cur) and sg.live(nxt)) or nxt == cur \
                    or nxt == sg.rc(cur):
                continue
            gap = nxt_x - cur_end
            if gap > max_gap:
                if log:
                    log("info", f"built {n_chain} contig scaffold")
                cur, cur_end = nxt, nxt_x + sg.base_size(nxt)
                n_chain = 1
                continue
            cur_end = nxt_x + sg.base_size(nxt)
            n_chain += 1
            gp = sg.gap_path(gap)
            n_id, _ = sg.link([cur, gp, nxt])
            sg.erase(cur)
            sg.erase(gp)
            sg.erase(nxt)
            cur = n_id
            joins += 1
        if log:
            log("info", f"built {n_chain} contig scaffold of "
                        f"{sg.base_size(cur)} bases")
    if log:
        log("info", f"scaffold: {joins} joins")
    return joins
