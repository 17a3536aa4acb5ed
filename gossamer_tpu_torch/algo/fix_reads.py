"""Graph-guided read error correction — the real fix-reads algorithm
(host copy of ``gossamer_tpu/algo/fix_reads.py``).

Redesign of ``src/GossCmdFixReads.cc:556-1276`` (Scanner::operator()):

1. **Variable-k anchoring** (``:562-632``): at each read position, binary
   search the largest k' in [loK, rho] whose k'-prefix of the window
   matches exactly ONE graph edge — vectorized here as a lane-parallel
   binary search (two ``searchsorted`` per iteration over all windows).
2. **Segment mapping** (``:656-680``): anchor rank -> (linear segment,
   offset), from the precomputed chain decomposition.
3. **Isolated-hit cancellation** (``:683-706``): drop sole hits on
   segments spanning past both read ends.
4. **Probabilistic pairing + disjoint sets** (``:708-800``): position
   pairs on the same / adjacent segments score
   ``coProb(k_i) * coProb(k_j) * P(offset | path distance; indel
   normal)``; pairs >= 1e-9 union into components.
5. **Greedy fragment assembly** (``:838-1010``): components by
   decreasing weight claim read ranges, chain hits via best links,
   fill edges along segments (one junction max per link), extend to
   the read ends along linear paths with a local-alignment length fit.
6. **Output** (``:1015-1052``): corrected bases uppercase, uncorrected
   gaps lowercase, header ``>label origLen,corrLen,nComps,nJuncs,[segs]``.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import kmer as K
from ..graph.graph import Graph
from ..graph.segments import decompose

MIN_HIT_PAIR_P = 1.0e-9   # sMinHitPairP (GossCmdFixReads.cc:248)
INDEL_RATE = 0.15         # sIndelRate (GossCmdFixReads.cc:245)
GAP_COST, SUBST_COST, MATCH_COST = -1, -4, 1  # matchLen (:484-489)


class FixReadsEngine:
    def __init__(self, g: Graph, log=None):
        assert 2 * g.rho <= 64, "fix-reads engine requires narrow keys"
        self.g = g
        self.rho = g.rho
        self.log = log or (lambda *a: None)
        self.lo_k = max(1, int(math.ceil(math.log(max(g.count, 2), 4))))
        self.seg = decompose(g)
        # rank -> segment id (index into seg_start) and offset; cyclic
        # edges get segment -1 and are not anchored
        self.rank_seg = np.full(g.count, -1, np.int64)
        self.rank_off = np.zeros(g.count, np.int64)
        ok = ~self.seg.cyclic
        self.rank_seg[ok] = np.searchsorted(self.seg.seg_start,
                                            self.seg.start[ok])
        self.rank_off[ok] = self.seg.pos[ok]
        # segment adjacency: followers(u) = segments of the out-edges of
        # u's final to-node (the reference's mHood neighborhood array)
        last = self.seg.order[self.seg.seg_off + self.seg.seg_len - 1]
        tlo, thi = g.to_node(g.lo[last], g.hi[last])
        b, e = g.begin_end_rank(tlo, thi)
        self.followers: list[set[int]] = []
        for i in range(len(last)):
            segs = set(self.rank_seg[np.arange(b[i], e[i])].tolist())
            segs.discard(-1)
            self.followers.append(segs)

    # ------------------------------------------------------------- anchoring
    def anchor(self, codes: np.ndarray):
        """Per-position (found_k, rank) arrays (0 / -1 where no anchor).

        Lane-parallel version of the binary search at
        ``GossCmdFixReads.cc:567-632``.
        """
        rho = self.rho
        n = len(codes)
        found = np.zeros(n, np.int64)
        rank = np.full(n, -1, np.int64)
        n_win = n - rho + 1
        if n_win <= 0:
            return found, rank
        win = np.zeros(n_win, np.uint64)
        valid = np.ones(n_win, bool)
        for j in range(rho):
            b = codes[j : j + n_win]
            valid &= b < 4
            win = (win << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
        glo = self.g.lo
        lk = np.full(n_win, self.lo_k, np.int64)
        hk = np.full(n_win, rho, np.int64)
        fk = np.zeros(n_win, np.int64)
        frk = np.full(n_win, -1, np.int64)
        lk[~valid] = rho + 1  # deactivate invalid lanes
        while True:
            active = lk <= hk
            if not active.any():
                break
            mk = (lk + hk) // 2
            s = (np.uint64(2) * (np.uint64(rho) - mk.astype(np.uint64)))
            pref = (win >> s) << s
            upper = pref + (np.uint64(1) << s)
            left = np.searchsorted(glo, pref)
            right = np.searchsorted(glo, upper)
            cnt = right - left
            zero = active & (cnt == 0)
            many = active & (cnt > 1)
            one = active & (cnt == 1)
            hk = np.where(zero, mk - 1, hk)
            lk = np.where(many | one, mk + 1, lk)
            fk = np.where(one, mk, fk)
            frk = np.where(one, left, frk)
        # anchors on cyclic edges are unusable for segment chaining
        on_cyc = (frk >= 0) & (self.rank_seg[np.maximum(frk, 0)] < 0)
        fk[on_cyc] = 0
        frk[on_cyc] = -1
        found[:n_win] = fk
        rank[:n_win] = frk
        return found, rank

    # -------------------------------------------------------------- pairing
    def _co_prob(self, k: int) -> float:
        """P(k-mer absent from a random graph) (``:348-351``)."""
        return 1.0 - min(1.0, self.g.count / float(4 ** k))

    def _dist(self, si, oi, sj, oj) -> int:
        """Path distance between two hits (``:325-345``)."""
        if si == sj:
            d = oj - oi
            return d if d > 0 else 0
        if sj in self.followers[si]:
            return int(self.seg.seg_len[si]) - oi + oj
        return 0

    def _prob_hit_pair(self, si, oi, ki, sj, oj, kj, i, j) -> float:
        l = self._dist(si, oi, sj, oj)
        if l == 0:
            return 0.0
        o = j - i
        v = 2.0 * l * INDEL_RATE * (1.0 - INDEL_RATE)
        sd = math.sqrt(v)
        z = abs(o - l) / sd if sd > 0 else float("inf")
        pr_dist = 0.5 * math.erfc(z / math.sqrt(2.0))
        return self._co_prob(ki) * self._co_prob(kj) * 2.0 * pr_dist

    # -------------------------------------------------------------- fix one
    def fix_read(self, seq: bytes):
        """-> (corrected string, n_components, n_junctions, used_segs)."""
        codes = K.encode_bases(seq)
        n = len(codes)
        found, rank = self.anchor(codes)
        hits = np.nonzero(rank >= 0)[0]
        seg = self.rank_seg[np.maximum(rank, 0)]
        off = self.rank_off[np.maximum(rank, 0)]

        # group hit positions by segment
        seg_pos: dict[int, list[int]] = {}
        for i in hits:
            seg_pos.setdefault(int(seg[i]), []).append(int(i))

        # cancel isolated hits on segments spanning past both read ends
        for s, pos in list(seg_pos.items()):
            if len(pos) != 1:
                continue
            i = pos[0]
            path_len = int(self.seg.seg_len[s]) + self.g.k
            if int(off[i]) > i and path_len - int(off[i]) > n - i:
                rank[i] = -1
                found[i] = 0
                del seg_pos[s]

        # probabilistic pair links + disjoint sets over hit positions
        parent: dict[int, int] = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def join(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        pair_links: dict[int, list[tuple[float, int]]] = {}
        pair_pr: dict[tuple[int, int], float] = {}
        max_look = max(1, n // 3)
        for s, pos in seg_pos.items():
            for x, i in enumerate(pos):
                if rank[i] < 0:
                    continue
                # later hits on this segment
                for j in pos[x + 1 :]:
                    if rank[j] < 0:
                        continue
                    pr = self._prob_hit_pair(s, int(off[i]), int(found[i]),
                                             s, int(off[j]), int(found[j]),
                                             i, j)
                    if pr >= MIN_HIT_PAIR_P:
                        pair_links.setdefault(i, []).append((pr, j))
                        pair_pr[(i, j)] = pr
                        join(i, j)
                # hits in following segments, within the look-ahead
                for s2 in self.followers[s]:
                    for j in seg_pos.get(s2, []):
                        if j <= i or j > i + max_look or rank[j] < 0:
                            continue
                        pr = self._prob_hit_pair(
                            s, int(off[i]), int(found[i]),
                            s2, int(off[j]), int(found[j]), i, j)
                        if pr >= MIN_HIT_PAIR_P:
                            pair_links.setdefault(i, []).append((pr, j))
                            pair_pr[(i, j)] = pr
                            join(i, j)

        groups: dict[int, list[int]] = {}
        weight: dict[int, float] = {}
        for (i, j), pr in pair_pr.items():
            rep = find(i)
            weight[rep] = weight.get(rep, 0.0) + pr
        for i in set(x for p in pair_pr for x in p):
            groups.setdefault(find(i), []).append(i)

        if not weight:
            return seq.decode().lower(), 0, 0, []

        reps = sorted(weight, key=lambda r: -weight[r])
        used = np.zeros(n, bool)
        frags: list[tuple[int, int, str]] = []
        n_used_comps = 0
        n_juncs = 0
        used_segs: list[int] = []

        for rep in reps:
            comp = groups[rep]
            first_hit = min(comp)
            first_pos = first_hit
            cur = first_hit
            edges: list[int] = []
            comp_segs: list[int] = []
            comp_juncs = 0
            fits = True
            while True:
                cs = int(seg[cur])
                if not comp_segs or comp_segs[-1] != cs:
                    comp_segs.append(cs)
                links = pair_links.get(cur, [])
                if not links:
                    break
                nxt = max(links)[1]
                if used[cur : nxt + 1].any():
                    fits = False
                    break
                comp_juncs += self._fill_edges(cur, nxt, seg, off, rank,
                                               edges)
                cur = nxt
            if not fits:
                continue
            edges.append(int(rank[cur]))
            used[first_hit : cur + 1] = True
            last_pos = cur + int(found[cur]) - 1

            # extend backwards along the first linear path
            if first_pos != 0:
                first_pos, edges, fits = self._extend_back(
                    first_pos, int(seg[first_pos]), int(off[first_pos]),
                    edges, used, seq)
            if not fits:
                continue
            # extend forwards along the last linear path
            if last_pos < n:
                last_pos, edges, fits = self._extend_fwd(
                    cur, last_pos, n, int(seg[cur]), int(off[cur]),
                    edges, used, seq)
            if not fits:
                continue
            frags.append((first_pos, min(last_pos, n),
                          self._sequence(edges)))
            n_used_comps += 1
            n_juncs += comp_juncs
            used_segs.extend(comp_segs)

        frags.sort()
        out = []
        gap = 0
        s = seq.decode()
        for a, b, text in frags:
            out.append(s[gap:a].lower())
            out.append(text)
            gap = b
        out.append(s[gap:].lower())
        return "".join(out), n_used_comps, n_juncs, used_segs

    # ------------------------------------------------------------- helpers
    def _chain_slice(self, s: int, a: int, b: int) -> list[int]:
        o = int(self.seg.seg_off[s])
        return self.seg.order[o + a : o + b].tolist()

    def _fill_edges(self, i, j, seg, off, rank, edges: list[int]) -> int:
        """Edges from hit i to hit j (exclusive); 1 if a junction is
        crossed (``:374-406``)."""
        si, sj = int(seg[i]), int(seg[j])
        oi, oj = int(off[i]), int(off[j])
        if si == sj:
            edges.extend(self._chain_slice(si, oi, oj))
            return 0
        edges.extend(self._chain_slice(si, oi, int(self.seg.seg_len[si])))
        edges.extend(self._chain_slice(sj, 0, oj))
        return 1

    def _extend_back(self, first_pos, s, o, edges, used, seq):
        """``:893-950``: prepend the linear path up to the read start."""
        read_before = first_pos
        path_before = o
        if path_before <= self.rho:
            return first_pos, edges, True
        if path_before >= read_before:
            if used[:first_pos].any():
                return first_pos, edges, True  # keep fragment, no extend
            pre = self._chain_slice(s, o - read_before, o)
            return 0, pre + edges, True
        # path starts inside the read: align to find the matched length
        pre = self._chain_slice(s, 0, o)
        path_seq = self._sequence(pre + [edges[0]])[: path_before]
        ln = _match_len_reverse(seq[:first_pos].decode(), path_seq)
        if ln and not used[first_pos - ln : first_pos].any():
            return first_pos - ln, pre + edges, True
        return first_pos, edges, True

    def _extend_fwd(self, cur, last_pos, n, s, o, edges, used, seq):
        """``:957-1010``: append the linear path up to the read end."""
        read_after = n - last_pos
        seg_len = int(self.seg.seg_len[s])
        path_after = seg_len - o
        if read_after <= 0 or path_after <= self.rho:
            return last_pos, edges, True
        if path_after >= read_after:
            if used[last_pos : n - 1].any():
                return last_pos, edges, True
            edges = edges[:-1] + self._chain_slice(s, o, o + read_after)
            return n, edges, True
        post = self._chain_slice(s, o, seg_len)
        path_seq = self._sequence(post)[self.rho :]
        ln = _match_len(seq[last_pos:].decode(), path_seq)
        if ln and not used[last_pos : last_pos + ln].any():
            edges = edges[:-1] + post
            return last_pos + ln, edges, True
        return last_pos, edges, True

    def _sequence(self, edges: list[int]) -> str:
        """Edge-rank path -> bases (``:1071-1083``)."""
        if not edges:
            return ""
        from .contigs import segment_sequence

        return segment_sequence(self.g, np.array(edges, np.int64)) \
            .tobytes().decode()


def _match_len(read: str, path: str) -> int:
    """Best-prefix local alignment length of read vs path
    (``GossCmdFixReads.cc:484-523``): returns the read length whose
    alignment against the path scores best."""
    m, n = len(read), len(path)
    if m == 0 or n == 0:
        return 0
    f = [j * GAP_COST for j in range(n + 1)]
    best, best_i = n * GAP_COST, 0
    for i in range(1, m + 1):
        prev = i * GAP_COST
        for j in range(1, n + 1):
            ins = f[j] + GAP_COST
            dele = prev + GAP_COST
            mat = f[j - 1] + (MATCH_COST if read[i - 1] == path[j - 1]
                              else SUBST_COST)
            cur = max(mat, dele, ins)
            f[j - 1] = prev
            prev = cur
        f[n] = prev
        if prev > best:
            best, best_i = prev, i
    return best_i


def _match_len_reverse(read: str, path: str) -> int:
    """``:537-556``: the same fit running backwards from the anchor."""
    return _match_len(read[::-1], path[::-1])
