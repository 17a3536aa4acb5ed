"""thread-reads / thread-pairs: superpath joining guided by reads (host
copy of ``gossamer_tpu/algo/threading.py``).

Algorithm parity with ``src/GossCmdThreadReads.cc`` and
``src/GossCmdThreadPairs.cc`` (call stacks in SURVEY.md §3.3):

* k-mer -> superpath anchoring (``src/KmerAligner.hh``,
  ``src/EdgeIndex.cc``) is replaced by a *full* vectorized edge ->
  (segment, offset) table from the pointer-doubling decomposition — the
  reference subsamples ranks to save memory (``--edge-cache-rate``); at
  8 bytes/edge we index everything.
* read linking (``ReadLinker::push_back``, ``GossCmdThreadReads.cc:330-385``):
  runs of identical unique superpath ids; a link (a, b, gap) per id
  transition, gap = misses since the previous transition.
* pair linking (``src/PairLinker.hh:117-250``): orientation-normalized
  (PairedEnds/Innies, MatePairs, Outies), vote-based whole-read anchoring
  (``src/PairAligner.hh:61-81``).
* link filtering + the fixed-point join loops mirror the reference,
  including the rc-link bookkeeping on ``sg.link``.

Read ids come from read starts, never from the 255 codes of the window
stream: a base other than ACGT encodes as 255 too, and the reference
skips the invalid windows inside one read and keeps its links across them
(the JAX package's ``np.cumsum(flat == SEP)`` cuts such a read in two).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Iterable

import numpy as np

from ..core import kmer as K
from ..graph.graph import Graph
from ..graph.segments import decompose
from ..graph.supergraph import SEG_MASK, SuperGraph, seg_is_linear
from ..io.readers import Read

SEP = np.uint8(255)


class PathIndex:
    """kmer -> (superpath id, offset) anchoring (EdgeIndex + KmerAligner).

    ``cache_rate`` is the reference's ``--edge-cache-rate`` divisor: when
    > 0, only edge ranks with ``rank & ((1 << rate) - 1) == 0`` anchor
    (``src/EdgeIndex.hh:63-73``) and the index stores 1/2^rate of the
    edge table; vote-based read anchoring tolerates the misses exactly
    as the reference's ``PairAligner`` does (``src/PairAligner.hh:61-81``).
    """

    def __init__(self, g: Graph, sg: SuperGraph, cache_rate: int = 0):
        self.g = g
        self.sg = sg
        self.cache_rate = int(cache_rate)
        dec = decompose(g)
        n = g.count
        # graph edge -> (entry segment index, offset within segment)
        seg_idx = np.searchsorted(dec.seg_off, np.arange(len(dec.order)),
                                  side="right") - 1
        if self.cache_rate > 0:
            # build ONLY the sampled 1/2^rate table (the round-3 version
            # materialized the full 16 B/edge table first and then
            # subsampled — at 600M edges that transient was 9.6 GB)
            rate_mask = np.int64((1 << self.cache_rate) - 1)
            m = (dec.order & rate_mask) == 0
            sel_edge = dec.order[m] >> np.int64(self.cache_rate)
            n_s = (n + (1 << self.cache_rate) - 1) >> self.cache_rate
            self.edge_seg = np.full(n_s, -1, dtype=np.int64)
            self.edge_off = np.zeros(n_s, dtype=np.int64)
            self.edge_seg[sel_edge] = seg_idx[m]
            self.edge_off[sel_edge] = dec.pos[dec.order[m]]
            step = 1 << self.cache_rate
            self._sampled_lo = np.ascontiguousarray(g.lo[::step])
            self._sampled_hi = np.ascontiguousarray(g.hi[::step])
        else:
            self._sampled_lo = self._sampled_hi = None
            self.edge_seg = np.full(n, -1, dtype=np.int64)
            self.edge_off = np.zeros(n, dtype=np.int64)
            self.edge_seg[dec.order] = seg_idx
            self.edge_off[dec.order] = dec.pos[dec.order]
        # entry segment -> (unique superpath, offset of segment in path)
        n_seg = len(dec.seg_start)
        self.seg_path = np.full(n_seg, -1, dtype=np.int64)
        self.seg_path_off = np.zeros(n_seg, dtype=np.int64)
        owners: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for pid in sg.path_ids():
            off = 0
            for s in sg.segs[pid]:
                if seg_is_linear(s):
                    owners[s & SEG_MASK].append((pid, off))
                    off += int(sg.entries.lengths[s & SEG_MASK])
                else:
                    from ..graph.supergraph import seg_gap

                    off += seg_gap(s)
        for seg, lst in owners.items():
            if len(lst) == 1:
                self.seg_path[seg] = lst[0][0]
                self.seg_path_off[seg] = lst[0][1]

    def align_kmers(self, lo: np.ndarray, hi: np.ndarray):
        """(pid, offset, ok) per raw rho-mer lane."""
        if self._sampled_lo is not None:
            # cache-rate fast path: a key anchors iff its FULL-set rank
            # is ≡ 0 mod 2^rate, i.e. iff it appears in the sorted
            # 1/2^rate subset g.lo[::2^rate] — searched directly, so the
            # lookup runs over a cache-resident array 2^rate smaller
            from ..graph.kmer_set import rank128

            r = rank128(self._sampled_lo, self._sampled_hi,
                        np.asarray(lo, np.uint64), np.asarray(hi, np.uint64))
            ns = len(self._sampled_lo)
            safe_s = np.minimum(r, ns - 1)
            hit = (r < ns) & (self._sampled_lo[safe_s] == lo)
            if self._sampled_hi is not None and len(self._sampled_hi):
                hit &= self._sampled_hi[safe_s] == hi
        else:
            hit, r = self.g.access_and_rank(lo, hi)
            if self.cache_rate > 0:
                mask = r.dtype.type((1 << self.cache_rate) - 1)
                hit = hit & ((r & mask) == 0)
                r = r >> r.dtype.type(self.cache_rate)
        safe = np.minimum(r, max(len(self.edge_seg) - 1, 0))
        seg = self.edge_seg[safe]
        ok = hit & (seg >= 0)
        seg = np.where(ok, seg, 0)
        pid = self.seg_path[seg]
        ok &= pid >= 0
        off = self.seg_path_off[seg] + self.edge_off[safe]
        return np.where(ok, pid, -1), off, ok


class UniquenessCache:
    """``SuperGraph::unique`` Zerbino/Pebble heuristic (``SuperGraph.cc:666-700``)."""

    def __init__(self, sg: SuperGraph, coverage: float):
        self.sg = sg
        self.cov = float(coverage)
        self.cache: dict[int, bool] = {}

    def unique(self, pid: int) -> bool:
        got = self.cache.get(pid)
        if got is not None:
            return got
        v = self._compute(pid)
        self.cache[pid] = v
        return v

    def _compute(self, pid: int) -> bool:
        sg = self.sg
        e = sg.entries
        if sg.is_gap(pid):
            return False
        if sg.size(pid) + e.k < 50:
            return False
        n = 0.0
        c = 0.0
        for s in sg.segs[pid]:
            if seg_is_linear(s):
                l = float(e.lengths[s & SEG_MASK])
                n += l
                c += l * float(e.counts[s & SEG_MASK])
        if n == 0:
            return False
        c /= n
        rho = self.cov
        kconst = math.log(2.0) / 2.0
        f = kconst + (n / (2 * rho)) * (rho * rho - (c * c) / 2.0)
        return f >= 5.0


def _read_ids(lengths: np.ndarray, n_win: int) -> np.ndarray:
    """Read id of each window of a stream of reads of ``lengths``, each
    followed by one separator: taken from read starts, so an ``N`` (255
    too) does not start a new read."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return np.repeat(np.arange(len(lengths), dtype=np.int64),
                     lengths + 1)[:n_win]


def _kmerize(flat: np.ndarray, rho: int):
    """(lo, hi, valid) of every window of a code stream: the native
    rolling k-merizer for narrow keys when the library is there, the
    numpy shift-or loop otherwise."""
    n_win = len(flat) - rho + 1
    if 2 * rho <= 64:
        from ..io.native import native_kmerize_u64, native_or_none

        nat = native_or_none("kmerize", native_kmerize_u64, flat, rho)
        if nat is not None:
            lo, valid8 = nat
            return lo, np.zeros(n_win, np.uint64), valid8.astype(bool)
    lo = np.zeros(n_win, dtype=np.uint64)
    hi = np.zeros(n_win, dtype=np.uint64)
    valid = np.ones(n_win, dtype=bool)
    for j in range(rho):
        b = flat[j : j + n_win]
        valid &= b < 4
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
    return lo, hi, valid


def _window_kmers(codes_list: list[np.ndarray], rho: int):
    """Flat windows with read ids: (lo, hi, valid, read_id, pos_in_read)."""
    parts = []
    for c in codes_list:
        parts.append(c)
        parts.append(np.array([SEP], dtype=np.uint8))
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if len(flat) < rho:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, bool), np.zeros(0, np.int64), np.zeros(0, np.int64)
    n_win = len(flat) - rho + 1
    lengths = np.array([len(c) for c in codes_list], dtype=np.int64)
    win_read = _read_ids(lengths, n_win)
    # position within read: global pos - read start
    starts = np.concatenate([[0], np.cumsum(lengths + 1)])
    pos = np.arange(n_win, dtype=np.int64) - starts[win_read]
    lo, hi, valid = _kmerize(flat, rho)
    return lo, hi, valid, win_read, pos


# ----------------------------------------------------------- thread-reads
class BiLinks:
    def __init__(self):
        self.count: dict[tuple[int, int], int] = defaultdict(int)
        self.gap_sum: dict[tuple[int, int], int] = defaultdict(int)

    def add(self, a: int, b: int, gap: int) -> None:
        self.count[(a, b)] += 1
        self.gap_sum[(a, b)] += gap

    def avg_gap(self, a: int, b: int) -> int:
        c = self.count[(a, b)]
        return self.gap_sum[(a, b)] // c if c else 0


def _read_blocks(reads: Iterable, batch: int):
    buf: list = []
    for rd in reads:
        buf.append(rd)
        if len(buf) >= batch:
            yield buf
            buf = []
    if buf:
        yield buf


def collect_read_links(
    reads: Iterable[Read], idx: PathIndex, ucache: UniquenessCache, rho: int,
    batch: int = 8192, num_threads: int = 1,
) -> BiLinks:
    """Link extraction over read blocks on T threads (the reference's
    ``BackgroundMultiConsumer`` of ``ReadLinker``s,
    ``src/GossCmdThreadReads.cc:330-385``): workers do the vectorized
    align + group-by, the main thread merges the commutative sums."""
    links = BiLinks()

    def flush(buf):
        codes = [K.encode_bases(r.seq) for r in buf]
        lo, hi, valid, rid, _pos = _window_kmers(codes, rho)
        return _links_from_windows(lo, hi, valid, rid, idx, ucache)

    def merge(res):
        _merge_link_arrays(links, res)

    from ..utils.batch_task import BatchTask

    BatchTask(num_threads).run(_read_blocks(reads, batch), flush, merge)
    return links


def collect_read_links_flat(
    blocks: Iterable[tuple[np.ndarray, np.ndarray]], idx: PathIndex,
    ucache: UniquenessCache, rho: int, num_threads: int = 1,
) -> BiLinks:
    """:func:`collect_read_links` over read-aligned flat code blocks, each
    with the lengths of its reads (:func:`blocks_with_read_lengths`): no
    per-read Python objects, no encode pass — the native reader's
    255-separated stream feeds the window kernel directly, and the read
    lengths tell read ends from ``N``s."""
    links = BiLinks()

    def flush(block):
        flat, lengths = block
        n_win = len(flat) - rho + 1
        if n_win <= 0:
            return None
        lo, hi, valid = _kmerize(flat, rho)
        return _links_from_windows(lo, hi, valid, _read_ids(lengths, n_win),
                                   idx, ucache)

    def merge(res):
        _merge_link_arrays(links, res)

    from ..utils.batch_task import BatchTask

    BatchTask(num_threads).run(blocks, flush, merge)
    return links


def blocks_with_read_lengths(blocks: Iterable[np.ndarray],
                             lengths: np.ndarray):
    """Pair each read-aligned block (in stream order) with the lengths of
    the reads it holds -> ``(block, lengths)``; raises when a block does
    not end where a read does or the reads run out."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ends = np.cumsum(lengths + 1)
    at = 0
    pos = 0
    for flat in blocks:
        pos += len(flat)
        stop = int(np.searchsorted(ends, pos))
        if stop >= len(ends) or ends[stop] != pos:
            raise ValueError(f"a read block ends at code {pos}, which is no "
                             f"read end of the counted lengths")
        mine = lengths[at : stop + 1]
        last = np.cumsum(mine + 1) - 1
        if not (flat[last] == SEP).all():
            raise ValueError("a read block has no separator at a read end")
        yield flat, mine
        at = stop + 1
    if at != len(lengths):
        raise ValueError(f"the read blocks hold {at} reads, the files "
                         f"{len(lengths)}")


def _links_from_windows(lo, hi, valid, rid, idx: PathIndex,
                        ucache: UniquenessCache):
    """Shared link extractor: aligned windows -> grouped (a, b, count,
    gap_sum) arrays (the reference's ReadLinker transition scan,
    ``src/GossCmdThreadReads.cc:330-385``, as one lexsort group-by)."""
    pid, _off, ok = idx.align_kmers(lo, hi)
    ok &= valid
    n = len(lo)
    if n:
        # KmerAligner fast-path INHERITANCE (``src/KmerAligner.hh:
        # 169-214``): a k-mer that is the unique graph successor of the
        # previous k-mer keeps the previous SEGMENT attribution — even
        # across segment boundaries through out-degree-1 nodes.  A read
        # walking arm -> shared middle therefore keeps reporting the
        # arm's path (gap stays 0) until a divergence node breaks the
        # chain.  Gold-parity-critical (tests/test_ref_parity_threading):
        # without this the middle k-mers attribute to their own
        # non-unique path and every link carries a spurious gap.
        tlo, thi = idx.g.to_node(lo, hi)
        outd = np.asarray(idx.g.out_degree(tlo, thi))
        cont = np.zeros(n, bool)
        cont[1:] = (valid[1:] & valid[:-1] & (rid[1:] == rid[:-1])
                    & ok[:-1] & ok[1:] & (outd[:-1] == 1))
        start_idx = np.where(~cont, np.arange(n, dtype=np.int64),
                             np.int64(-1))
        np.maximum.accumulate(start_idx, out=start_idx)
        pid = pid[start_idx]
        ok = ok[start_idx] & valid
    # uniqueness per distinct pid (cached host-side)
    upids = np.unique(pid[ok & (pid >= 0)])
    uniq = np.array([int(p) for p in upids if ucache.unique(int(p))],
                    dtype=np.int64)
    is_hit = ok & np.isin(pid, uniq)
    hits = np.nonzero(is_hit)[0]
    if len(hits) == 0:
        return None
    h_read = rid[hits]
    h_pid = pid[hits]
    # gap counts EMITTED k-mers (the reference's GossRead::Iterator
    # skips invalid windows entirely — they never increment gap)
    h_pos = np.cumsum(valid.astype(np.int64))[hits]
    # new-id events: first hit of a read, or pid change vs previous hit
    new_id = np.ones(len(hits), dtype=bool)
    new_id[1:] = (h_read[1:] != h_read[:-1]) | (h_pid[1:] != h_pid[:-1])
    ev = np.nonzero(new_id)[0]
    if len(ev) < 2:
        return None
    # consecutive event pairs within one read -> (a, b, gap) link records
    p_ev, c_ev = ev[:-1], ev[1:]
    same = h_read[p_ev] == h_read[c_ev]
    p_ev, c_ev = p_ev[same], c_ev[same]
    if len(p_ev) == 0:
        return None
    a = h_pid[p_ev]
    b = h_pid[c_ev]
    gap = (h_pos[c_ev] - h_pos[p_ev]) - (c_ev - p_ev)
    order = np.lexsort((b, a))
    a, b, gap = a[order], b[order], gap[order]
    first = np.ones(len(a), dtype=bool)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    starts = np.nonzero(first)[0]
    cnts = np.diff(np.append(starts, len(a)))
    gsums = np.add.reduceat(gap, starts)
    return a[starts], b[starts], cnts, gsums


def _merge_link_arrays(links: BiLinks, res) -> None:
    if res is None:
        return
    for ai, bi, ci, gi in zip(*res):
        key = (int(ai), int(bi))
        links.count[key] += int(ci)
        links.gap_sum[key] += int(gi)


def _filter_links(links: BiLinks, min_count: int) -> dict[tuple[int, int], int]:
    """count >= min, then lhs-unique, then rhs-unique (most-supported wins)."""
    good = {l: c for l, c in links.count.items() if c >= min_count}
    by_lhs: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for (a, b), c in good.items():
        by_lhs[a].append((b, c))
    stage2 = {}
    for a, bs in by_lhs.items():
        b = max(bs, key=lambda t: t[1])[0]
        stage2[(a, b)] = links.avg_gap(a, b)
    by_rhs: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for (a, b) in stage2:
        by_rhs[b].append((a, links.count[(a, b)]))
    final = {}
    for b, as_ in by_rhs.items():
        a = max(as_, key=lambda t: t[1])[0]
        final[(a, b)] = stage2[(a, b)]
    return final


def _find_path(sg: SuperGraph, a: int, b: int, gap: int, radius: int) -> list[int] | None:
    """``findPath`` (``GossCmdThreadReads.cc:474-545``), faithfully: the
    reference's thread-reads search IS a bounded DFS — recursion depth
    ``pStepsLeft`` (= radius), abandon when accumulated length exceeds
    ``pGap * 1.5`` (``:491-495``), then keep the candidate whose
    intermediate length is closest to the gap (``:523-541``).  The
    deviation-path iterator (``SuperGraph::ShortestPathIterator``,
    mirrored in :meth:`gossamer_tpu.graph.supergraph.SuperGraph.
    shortest_path_iter`) is what *thread-pairs* uses for its candidate
    paths (``GossCmdThreadPairs.cc``); thread-reads never calls it."""
    if gap == 0:
        return [a, b]
    results: list[tuple[int, list[int]]] = []

    def rec(at: int, steps: int, path: list[int], length: int):
        if at == b:
            results.append((length - sg.size(b), list(path)))
            return
        if length > gap * 1.5 or steps == 0:
            return
        node = sg.end(at)
        if node is None:
            return
        for nxt in list(sg.successors(node)):
            path.append(nxt)
            rec(nxt, steps - 1, path, length + sg.size(nxt))
            path.pop()

    rec(a, radius, [], 0)
    if not results:
        return None
    best = min(results, key=lambda t: abs(gap - t[0]))
    return [a] + best[1]


def _simplify(sg: SuperGraph) -> int:
    """Collapse new linear superpath chains (``GossCmdThreadReads.cc:592-636``)."""
    new_paths = 0
    removed: set[int] = set()
    for node in list(sg.succ.keys()):
        for pid in list(sg.succ.get(node, [])):
            if pid in removed or not sg.live(pid):
                continue
            chain = [pid]
            seen = {pid}
            p = pid
            while True:
                n2 = sg.end(p)
                if n2 is None or sg.num_out(n2) != 1 or sg.num_in(n2) != 1:
                    break
                p = sg.successors(n2)[0]
                if p in seen:
                    break
                seen.add(p)
                chain.append(p)
            if len(chain) > 1:
                new_paths += 1
                sg.link(chain)
                for c in chain:
                    if c not in removed and sg.live(c):
                        rc = sg.rc(c)
                        sg.erase(c)
                        removed.add(c)
                        removed.add(rc)
    return new_paths


def thread_reads(
    sg: SuperGraph,
    g: Graph,
    reads: Iterable[Read],
    *,
    min_link_count: int = 10,
    expected_coverage: float | None = None,
    edge_cache_rate: int = 0,
    num_threads: int = 1,
    log=None,
) -> int:
    from .coverage import estimate_coverage

    if expected_coverage is None:
        mult, freq = g.hist()
        expected_coverage = estimate_coverage(mult, freq)
        if log:
            log("info", f"estimated coverage = {expected_coverage}")
    idx = PathIndex(g, sg, edge_cache_rate)
    ucache = UniquenessCache(sg, expected_coverage)
    if isinstance(reads, tuple) and len(reads) == 2 and reads[0] == "flat":
        links = collect_read_links_flat(reads[1], idx, ucache, g.rho,
                                        num_threads=num_threads)
    else:
        links = collect_read_links(reads, idx, ucache, g.rho,
                                   num_threads=num_threads)
    if log:
        log("info", f"found {len(links.count)} links")
    lnks = _filter_links(links, min_link_count)
    if log:
        log("info", f"after filtering, {len(lnks)} links remain")

    # join loop (GossCmdThreadReads.cc:926-1040)
    new_paths = 0
    lhs_map = {a: b for (a, b) in lnks}
    rhs_map = {b: a for (a, b) in lnks}
    gaps = {l: g_ for l, g_ in lnks.items()}
    extd = True
    while extd:
        extd = False
        while lhs_map:
            a, b = next(iter(lhs_map.items()))
            a_rc = sg.rc(a)
            b_rc = sg.rc(b)
            gap = gaps.get((a, b), 0)
            lhs_map.pop(a, None)
            rhs_map.pop(b, None)
            # also drop the rc mirror link
            if lhs_map.get(b_rc) is not None:
                rhs_map.pop(lhs_map[b_rc], None)
                lhs_map.pop(b_rc, None)
            if rhs_map.get(a_rc) is not None:
                lhs_map.pop(rhs_map[a_rc], None)
                rhs_map.pop(a_rc, None)
            if a == b or a == a_rc or b == b_rc:
                continue
            if not (sg.live(a) and sg.live(b)):
                continue
            p = _find_path(sg, a, b, gap, 5)
            if p is None:
                continue
            extd = True
            new_paths += 1
            n_id, n_rc = sg.link(p)
            # re-point links touching a/b onto the new path
            _subst(rhs_map, lhs_map, gaps, old=a, new=n_id, side="rhs")
            _subst(lhs_map, rhs_map, gaps, old=b, new=n_id, side="lhs")
            _subst(lhs_map, rhs_map, gaps, old=a_rc, new=n_rc, side="lhs")
            _subst(rhs_map, lhs_map, gaps, old=b_rc, new=n_rc, side="rhs")
            sg.erase(a)
            if b != a and b != a_rc:
                sg.erase(b)
    new_paths += _simplify(sg)
    return new_paths


def _subst(primary: dict, other: dict, gaps: dict, *, old: int, new: int, side: str):
    """Replace path id `old` with `new` on one side of the link maps.

    ``side="rhs"``: primary is rhs_map (b -> a); link (x -> old) becomes
    (x -> new).  ``side="lhs"``: primary is lhs_map (a -> b); link
    (old -> y) becomes (new -> y).
    """
    if old not in primary:
        return
    if side == "rhs":
        x = primary.pop(old)
        primary[new] = x
        other[x] = new
        if (x, old) in gaps:
            gaps[(x, new)] = gaps.pop((x, old))
    else:
        y = primary.pop(old)
        primary[new] = y
        other[y] = new
        if (old, y) in gaps:
            gaps[(new, y)] = gaps.pop((old, y))


# ----------------------------------------------------------- thread-pairs
def collect_pair_links(
    pairs: Iterable[tuple[Read, Read]],
    idx: PathIndex,
    ucache: UniquenessCache,
    sg: SuperGraph,
    rho: int,
    orientation: str,
    batch: int = 1024,
    num_threads: int = 1,
):
    """(a, b) -> [count, lhs_off_sum, rhs_off_sum] + same-path distance hist."""
    links: dict[tuple[int, int], list[int]] = defaultdict(lambda: [0, 0, 0])
    dist_hist: dict[int, int] = defaultdict(int)
    k = rho - 1

    def align_batch(seqs: list[bytes], direction: str):
        """Per-read (path id, offset) anchor, the exact PairAligner /
        KmerAligner semantics (``src/PairAligner.hh:61-105``,
        ``src/KmerAligner.hh:53-214``):

        * Forward: candidate offset = (k-mer's path offset) - (k-mer's
          read offset), rejected when the read would start before the
          path (``pKmerOffs > off``).
        * RevComp: the k-mer attributes to its RC edge's segment (the
          reference walks the chain forward and indexes the rc-side
          segment — identical numbers); candidate offset = rc-path
          offset + read offset, no reject.
        * the fast-path INHERITANCE through out-degree-1 nodes carries
          (path, offset±1) across segment boundaries, exactly as in
          :func:`_links_from_windows`.
        * winner = max votes, ties toward the smallest (id, offset)
          (selectAnchor scans ascending std::maps).
        """
        codes = [K.encode_bases(s) for s in seqs]
        lo, hi, valid, rid, pos = _window_kmers(codes, rho)
        if direction == "fwd":
            pid, off, ok = idx.align_kmers(lo, hi)
        else:
            rlo, rhi = K.reverse_complement(lo, hi, rho)
            pid, off, ok = idx.align_kmers(rlo, rhi)
        ok &= valid
        n = len(lo)
        out: list[tuple[int, int] | None] = [None] * len(seqs)
        if n == 0:
            return out
        tlo, thi = idx.g.to_node(lo, hi)
        outd = np.asarray(idx.g.out_degree(tlo, thi))
        cont = np.zeros(n, bool)
        cont[1:] = (valid[1:] & valid[:-1] & (rid[1:] == rid[:-1])
                    & ok[:-1] & ok[1:] & (outd[:-1] == 1))
        start_idx = np.where(~cont, np.arange(n, dtype=np.int64),
                             np.int64(-1))
        np.maximum.accumulate(start_idx, out=start_idx)
        pid = pid[start_idx]
        step = np.arange(n, dtype=np.int64) - start_idx
        off = off[start_idx] + (step if direction == "fwd" else -step)
        ok = ok[start_idx] & valid
        if direction == "fwd":
            cand = off - pos
            ok = ok & (pos <= off)  # KmerAligner.hh:76-80
        else:
            cand = off + pos
        sel = np.nonzero(ok & (pid >= 0))[0]
        if len(sel) == 0:
            return out
        r = rid[sel]
        p = pid[sel]
        o = cand[sel]
        order = np.lexsort((o, p, r))
        r, p, o = r[order], p[order], o[order]
        first = np.ones(len(r), dtype=bool)
        first[1:] = (r[1:] != r[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
        starts = np.nonzero(first)[0]
        votes = np.diff(np.append(starts, len(r)))
        vr, vp, vo = r[starts], p[starts], o[starts]
        cand_order = np.lexsort((vo, vp, -votes, vr))
        read_first = np.ones(len(cand_order), dtype=bool)
        rs = vr[cand_order]
        read_first[1:] = rs[1:] != rs[:-1]
        win = cand_order[read_first]
        for r_, p_, o_ in zip(vr[win], vp[win], vo[win]):
            out[int(r_)] = (int(p_), int(o_))
        return out

    def flush(buf):
        n = len(buf)
        # which mate aligns Forward / RevComp, and which result plays
        # lhs vs rhs (PairLinker.hh:144-166)
        if orientation in ("paired-ends", "innies"):
            a1 = align_batch([a.seq for a, b in buf], "fwd")   # -> lhs
            a2 = align_batch([b.seq for a, b in buf], "rc")    # -> rhs
            lhs_of, rhs_of = a1, a2
        elif orientation == "mate-pairs":
            a1 = align_batch([a.seq for a, b in buf], "fwd")   # -> rhs
            a2 = align_batch([b.seq for a, b in buf], "rc")    # -> lhs
            lhs_of, rhs_of = a2, a1
        else:  # outies
            a1 = align_batch([b.seq for a, b in buf], "fwd")   # -> rhs
            a2 = align_batch([a.seq for a, b in buf], "rc")    # -> lhs
            lhs_of, rhs_of = a2, a1
        loc_links: list[tuple] = []
        loc_hist: list[int] = []
        for i in range(n):
            if lhs_of[i] is None or rhs_of[i] is None:
                continue
            lhs_id, lhs_off = lhs_of[i]
            rhs_id, rhs_off = rhs_of[i]
            if not (ucache.unique(lhs_id) and ucache.unique(rhs_id)):
                continue
            lhs_len = len(buf[i][0].seq)
            rhs_len = len(buf[i][1].seq)
            if orientation == "outies":  # PairLinker.hh:199-203
                lhs_start = lhs_off + k + 1 - lhs_len
                rhs_end = rhs_off + rhs_len - 1
            else:  # PairLinker.hh:189-194
                lhs_start = lhs_off
                rhs_end = rhs_off + k
            if lhs_id == rhs_id:
                loc_hist.append(rhs_end - lhs_start)
                continue
            rhs_rc = sg.rc(rhs_id)
            lhs_rc = sg.rc(lhs_id)
            lhs_path_len = sg.size(lhs_id) + k
            rhs_path_len = sg.size(rhs_rc) + k
            lhs_end = lhs_start + lhs_len
            rhs_start = rhs_end - rhs_len
            rhs_rc_end = rhs_path_len - rhs_start
            lhs_rc_start = lhs_path_len - lhs_end
            loc_links.append((lhs_id, rhs_id, lhs_start, rhs_end))
            loc_links.append((rhs_rc, lhs_rc, rhs_rc_end - rhs_len,
                              lhs_rc_start + lhs_len))
        return loc_links, loc_hist

    def merge(res):
        loc_links, loc_hist = res
        for a_, b_, l_, r_ in loc_links:
            e = links[(a_, b_)]
            e[0] += 1
            e[1] += l_
            e[2] += r_
        for d in loc_hist:
            dist_hist[d] += 1

    from ..utils.batch_task import BatchTask

    BatchTask(num_threads).run(_read_blocks(pairs, batch), flush, merge)
    return links, dist_hist


def _find_paths_between(sg: SuperGraph, a: int, b: int, init_len: int,
                        min_len: int, max_len: int, radius: int,
                        max_paths: int = 100) -> list[list[int]]:
    """Paths end(a) -> start(b) within the insert window, in non-decreasing
    length via the deviation-path iterator (``GossCmdThreadPairs.cc:525-570``:
    iterate ShortestPathIterator, break past max, skip short, cap count)."""
    source = sg.end(a)
    sink = sg.start(b)
    if source is None or sink is None:
        return []
    results: list[list[int]] = []
    n = 0
    for length, p in sg.shortest_path_iter(source, sink, max_len, radius):
        n += 1
        if n > max_paths:
            break
        sz = init_len + sum(sg.size(x) for x in p)
        if sz > max_len:
            break
        if sz < min_len:
            continue
        results.append(p)
    return results


def _dist_to_segment(sg: SuperGraph, path: list[int], frm: int, seg: int):
    """(found, extra_dist, cursor) — ``GossCmdThreadPairs.cc:572-591``."""
    d = 0
    for i in range(frm, len(path)):
        if path[i] == seg:
            return True, d, i
        d += sg.size(path[i])
    return False, 0, 0


def find_consensus_path(sg: SuperGraph, paths: list[list[int]]) -> list[int]:
    """Minimal-N common sub-path of all given paths, gap-filled with the
    mean skipped distance (``GossCmdThreadPairs.cc:594-660``)."""
    n = len(paths)
    out: list[int] = []
    cursor = [0] * n
    nxt = [0] * n
    while True:
        if any(cursor[i] >= len(paths[i]) for i in range(n)):
            return out
        d = 0
        s = paths[0][cursor[0]]
        found = True
        for i in range(1, n):
            if not found:
                break
            found, extra, nxt[i] = _dist_to_segment(
                sg, paths[i], cursor[i], s)
            d += extra
        if found:
            d //= n
            if d:
                out.append(sg.gap_path(d))
            out.append(s)
            cursor[0] += 1
            for i in range(1, n):
                cursor[i] = nxt[i] + 1
        else:
            cursor[0] += 1


def thread_pairs(
    sg: SuperGraph,
    g: Graph,
    pairs: Iterable[tuple[Read, Read]],
    *,
    orientation: str = "paired-ends",
    min_link_count: int = 10,
    insert_size: int | None = None,
    insert_std_dev_pct: float = 10.0,
    insert_tolerance: float = 2.0,
    expected_coverage: float | None = None,
    fill_gaps: bool = False,
    consolidate_paths: bool = False,
    max_gap: int = 1000,
    search_radius: int = 10,
    edge_cache_rate: int = 0,
    num_threads: int = 1,
    log=None,
) -> int:
    from .coverage import estimate_coverage

    if expected_coverage is None:
        mult, freq = g.hist()
        expected_coverage = estimate_coverage(mult, freq)
        if log:
            log("info", f"estimated coverage = {expected_coverage}")
    idx = PathIndex(g, sg, edge_cache_rate)
    ucache = UniquenessCache(sg, expected_coverage)
    links, dist_hist = collect_pair_links(pairs, idx, ucache, sg, g.rho,
                                          orientation,
                                          num_threads=num_threads)

    if insert_size is None:
        if dist_hist:
            # median same-path distance as the insert estimate
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
    dev = int(insert_size * insert_std_dev_pct / 100.0 * insert_tolerance)
    max_insert = insert_size + dev
    min_insert = max(insert_size - dev, 0)
    k = g.k

    # filter by count
    good = {l: v for l, v in links.items() if v[0] >= min_link_count}
    if log:
        log("info", f"{len(good)} links after count filter")

    new_paths = 0
    work = dict(good)

    # secondary indexes (segment id -> link keys) + a lazy min-heap, so
    # each join touches only its incident links instead of rescanning
    # all of ``work`` (round-2 Weak #4: the rescan was O(links^2))
    import heapq

    by_left: dict[int, set] = {}
    by_right: dict[int, set] = {}
    heap: list[tuple[int, int]] = []

    def _index_add(key) -> None:
        by_left.setdefault(key[0], set()).add(key)
        by_right.setdefault(key[1], set()).add(key)
        heapq.heappush(heap, key)

    def _index_del(key) -> None:
        by_left.get(key[0], set()).discard(key)
        by_right.get(key[1], set()).discard(key)

    for key in work:
        _index_add(key)

    def _work_pop(key):
        v = work.pop(key, None)
        if v is not None:
            _index_del(key)
        return v

    def _repoint(old_key, new_key, dl: int) -> None:
        """BiLinkMap::copy/add: move a link, shifting lhs offsets by dl."""
        v = _work_pop(old_key)
        if v is None:
            return
        cnt_, l_, r_ = v
        l_ += cnt_ * dl
        if new_key in work:
            c2, l2, r2 = work[new_key]
            work[new_key] = (c2 + cnt_, l2 + l_, r2 + r_)
        else:
            work[new_key] = (cnt_, l_, r_)
            _index_add(new_key)

    # Loop to fixed point in (a, b) order, restarting after every link
    # (``GossCmdThreadPairs.cc:926-1150``: every examined link either
    # joins the pair or is dropped).
    while work:
        key = heapq.heappop(heap)
        if key not in work:
            continue  # lazily-deleted heap entry
        a, b = key
        v = _work_pop(key)
        if a == b or not (sg.live(a) and sg.live(b)):
            continue
        cnt, l_sum, r_sum = v
        lhs_off = l_sum // cnt
        rhs_off = r_sum // cnt
        init_len = (sg.size(a) + k - lhs_off) + rhs_off
        init_gap = max(0, insert_size - init_len)
        ps = _find_paths_between(sg, a, b, init_len, min_insert,
                                 max_insert, search_radius)
        if not ps:
            if fill_gaps and init_gap < max_gap:
                p = [a] + ([sg.gap_path(init_gap)] if init_gap else []) + [b]
            else:
                continue
        elif len(ps) > 1:
            if not consolidate_paths:
                continue  # ambiguous
            full = [[a] + q + [b] for q in ps]
            p = find_consensus_path(sg, full)
            if len(p) < 2:
                continue
        else:
            p = [a] + ps[0] + [b]
        new_paths += 1
        a_rc = sg.rc(a)
        b_rc = sg.rc(b)
        b_sz = sg.size(b)
        a_rc_sz = sg.size(a_rc)
        n_id, n_rc = sg.link(p)
        # re-point remaining links onto the joined path, adjusting lhs
        # offsets where the joined path extends to the left
        # (``GossCmdThreadPairs.cc:1055-1120``) — via the incident-link
        # indexes, not a full-work rescan
        n_sz = sg.size(n_id)
        for key2 in list(by_right.get(a, ())):
            _repoint(key2, (key2[0], n_id), 0)
        for key2 in list(by_left.get(b, ())):
            _repoint(key2, (n_id, key2[1]), n_sz - b_sz)
        for key2 in list(by_left.get(a_rc, ())):
            _repoint(key2, (n_rc, key2[1]), n_sz - a_rc_sz)
        for key2 in list(by_right.get(b_rc, ())):
            _repoint(key2, (key2[0], n_rc), 0)
        # erase unique member paths (GossCmdThreadPairs.cc:1122-1139)
        deleted: set[int] = set()
        for s in p:
            if s in deleted or not sg.live(s):
                continue
            if ucache.unique(s):
                s_rc = sg.rc(s)
                deleted.add(s)
                deleted.add(s_rc)
                for sid in (s, s_rc):
                    for key2 in list(by_left.get(sid, ())) + list(
                            by_right.get(sid, ())):
                        _work_pop(key2)
                sg.erase(s)
    new_paths += _simplify(sg)
    return new_paths
