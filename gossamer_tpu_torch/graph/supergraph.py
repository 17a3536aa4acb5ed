"""SuperGraph: mutable assembly graph over linear segments (host copy of
``gossamer_tpu/graph/supergraph.py``).

Data-model parity with ``src/SuperGraph.{hh,cc}`` (``SuperGraph.hh:40-508``):

* ``succ``: node -> outgoing SuperPathIds (``mSucc``)
* ``segs``: id -> list of Segments; Segment is a tagged uint64 — linear
  path (entry rank), gap of n bases, or explicit sequence
  (``SuperPath.hh:45-98``)
* ``rcs``: id <-> rc id, doubling as the free list (``SuperGraph.cc:1234-1262``)
* ids allocate in rc pairs; ``link`` concatenates superpaths
  (``SuperGraph.cc:1089-1156``), ``gapPath`` makes N-gap paths, ``erase``
  removes a path + rc.

The structure is per-segment scale (tiny next to the Graph) and lives on
host, as in the reference; contig sequence extraction delegates to the
vectorized segment machinery.
"""

from __future__ import annotations

import numpy as np

from ..io.artifacts import read_array, read_header, write_array, write_header
from ..io.factory import FileFactory
from .entry_edge_set import EntryEdgeSet
from .graph import Graph

SUPERGRAPH_VERSION = 2011082301  # src/SuperGraph.hh:46
INVALID = (1 << 64) - 1

SEG_MASK = 0x3FFFFFFFFFFFFFFF
GAP_TAG = 1 << 62


def seg_is_linear(s: int) -> bool:
    return (s >> 62) == 0


def seg_is_gap(s: int) -> bool:
    return (s >> 62) == 1


def seg_gap(s: int) -> int:
    return (s & SEG_MASK) - (SEG_MASK >> 1)


def make_gap_seg(length: int) -> int:
    return GAP_TAG | (length + (SEG_MASK >> 1))


def supergraph_exists(basename: str, fac: FileFactory) -> bool:
    return fac.exists(basename + "-supergraph.header")


class SuperGraph:
    def __init__(self, entries: EntryEdgeSet):
        self.entries = entries
        self.succ: dict[int, list[int]] = {}
        self.segs: list[list[int]] = []
        self.rcs: list[int] = []
        self.next_id = entries.count
        self.count = entries.count

    # -- node keys --------------------------------------------------------
    def _nk(self, lo, hi) -> int:
        return (int(np.asarray(hi).item()) << 64) | int(np.asarray(lo).item())

    def seg_start_node(self, s: int) -> int:
        e = self.entries
        lo, hi = e.select(s & SEG_MASK)
        flo, fhi = e.from_node(lo, hi)
        return self._nk(flo, fhi)

    def seg_end_node(self, s: int) -> int:
        """End node of a linear segment = start node of its rc segment, rc'd."""
        e = self.entries
        rc_rank = int(e.end_rank[s & SEG_MASK])
        lo, hi = e.select(rc_rank)
        flo, fhi = e.from_node(lo, hi)
        rlo, rhi = e.node_rc(flo, fhi)
        return self._nk(rlo, rhi)

    # -- path accessors ---------------------------------------------------
    def first_linear(self, pid: int) -> int | None:
        for s in self.segs[pid]:
            if seg_is_linear(s):
                return s
        return None

    def last_linear(self, pid: int) -> int | None:
        for s in reversed(self.segs[pid]):
            if seg_is_linear(s):
                return s
        return None

    def start(self, pid: int) -> int | None:
        s = self.first_linear(pid)
        return None if s is None else self.seg_start_node(s)

    def end(self, pid: int) -> int | None:
        s = self.last_linear(pid)
        return None if s is None else self.seg_end_node(s)

    def is_gap(self, pid: int) -> bool:
        segs = self.segs[pid]
        return len(segs) == 1 and seg_is_gap(segs[0])

    def size(self, pid: int) -> int:
        """Length in edges (gaps count their base length)."""
        e = self.entries
        t = 0
        for s in self.segs[pid]:
            t += int(e.lengths[s]) if seg_is_linear(s) else seg_gap(s)
        return t

    def base_size(self, pid: int) -> int:
        """Length in bases (``SuperPath::baseSize``)."""
        e = self.entries
        t = e.k
        for s in self.segs[pid]:
            if seg_is_linear(s):
                t += int(e.lengths[s])
            else:
                t += seg_gap(s) + e.k
        return t

    def rc(self, pid: int) -> int:
        return self.rcs[pid]

    def successors(self, node: int) -> list[int]:
        return self.succ.get(node, [])

    def num_out(self, node: int) -> int:
        return len(self.succ.get(node, []))

    def num_in(self, node: int) -> int:
        e = self.entries
        lo = np.uint64(node & ((1 << 64) - 1))
        hi = np.uint64(node >> 64)
        rlo, rhi = e.node_rc(lo, hi)
        return self.num_out(self._nk(rlo, rhi))

    def path_ids(self) -> list[int]:
        return [i for i in range(len(self.segs)) if self.segs[i]]

    def live(self, pid: int) -> bool:
        return pid < len(self.segs) and bool(self.segs[pid])

    def node_rc_key(self, node: int) -> int:
        e = self.entries
        lo = np.uint64(node & ((1 << 64) - 1))
        hi = np.uint64(node >> 64)
        rlo, rhi = e.node_rc(lo, hi)
        return self._nk(rlo, rhi)

    # -- path search (``SuperGraph::shortestPaths`` + ShortestPathIterator) -
    def find_subgraph(self, node: int, out: set, radius: int,
                      rc: bool = False) -> None:
        """All SuperPathIds within ``radius`` steps (``SuperGraph.cc:340-371``);
        with ``rc`` their reverse complements are recorded instead."""
        if radius == 0:
            return
        for i in self.successors(node):
            rec = self.rcs[i] if rc else i
            if rec not in out:
                out.add(rec)
                end = self.end(i)
                if end is not None:
                    self.find_subgraph(end, out, radius - 1, rc)

    def shortest_paths(self, source: int, sink: int, max_length: int,
                       valid: set | None = None):
        """Dijkstra map node -> (dist to sink, next edge on a shortest
        path), or None if sink is unreachable within ``max_length``
        (``SuperGraph.cc:373-478``).  Run from rc(sink) over successors
        and rc-mapped back, exactly like the reference."""
        import heapq

        src = self.node_rc_key(sink)
        snk = self.node_rc_key(source)
        best: dict[int, tuple[int, int | None]] = {src: (0, None)}
        done: dict[int, tuple[int, int | None]] = {}
        heap: list[tuple[int, int]] = [(0, src)]
        found = False
        while heap:
            d, n = heapq.heappop(heap)
            if n in done or d > best.get(n, (d, None))[0]:
                continue
            if d > max_length:
                break
            if n == snk:
                found = True
            for i in self.successors(n):
                if valid is not None and i not in valid:
                    continue
                en = self.end(i)
                if en is None or en in done:
                    continue
                nl = d + self.size(i)
                cur = best.get(en)
                if cur is None or nl < cur[0]:
                    best[en] = (nl, i)
                    heapq.heappush(heap, (nl, en))
            done[n] = best[n]
        if not found:
            return None
        out: dict[int, tuple[int, int]] = {}
        for n, (d, e) in done.items():
            if d and e is not None:
                out[self.node_rc_key(n)] = (d, self.rcs[e])
        return out

    def shortest_path_iter(self, source: int, sink: int, max_length: int,
                           search_radius: int = 0):
        """Yield (length, [SuperPathId]) source->sink paths in
        non-decreasing length — the deviation-path enumeration of
        ``SuperGraph::ShortestPathIterator`` (``SuperGraph.cc:480-625``).
        """
        import heapq

        if source == sink:
            yield 0, []
            return
        valid: set | None = None
        if search_radius:
            valid = set()
            self.find_subgraph(source, valid, search_radius, rc=True)
        spd = self.shortest_paths(source, sink, max_length, valid)
        if spd is None or source not in spd:
            return
        heap: list[tuple[int, int, list[int]]] = [(spd[source][0], 0, [])]
        ctr = 1
        while heap:
            length, _, devs = heapq.heappop(heap)
            cur = source
            init_len = 0
            extend = True
            if devs:
                cur = self.end(devs[-1])
                if cur in spd:
                    init_len = length - spd[cur][0]
                else:
                    # deviation target out of shortest-path range: no
                    # shorter completions exist past it
                    extend = False
            if extend:
                while cur != sink:
                    min_edge = spd[cur][1]
                    for i in self.successors(cur):
                        if i == min_edge:
                            continue
                        dn = self.end(i)
                        if dn is None:
                            continue
                        if dn in spd or dn == sink:
                            dev_len = self.size(i)
                            if dn in spd:
                                dev_len += spd[dn][0]
                            heapq.heappush(
                                heap, (init_len + dev_len, ctr, devs + [i]))
                            ctr += 1
                    cur = self.end(min_edge)
                    init_len += self.size(min_edge)
            # reconstruct the full id sequence
            path: list[int] = []
            cur = source
            di = 0
            ok = True
            while cur != sink:
                if di < len(devs) and cur == self.start(devs[di]):
                    nxt = devs[di]
                    di += 1
                else:
                    if cur not in spd:
                        ok = False
                        break
                    nxt = spd[cur][1]
                path.append(nxt)
                cur = self.end(nxt)
            if ok:
                yield length, path

    # -- construction / editing -------------------------------------------
    @classmethod
    def create(cls, entries: EntryEdgeSet) -> "SuperGraph":
        sg = cls(entries)
        n = entries.count
        sg.segs = [[i] for i in range(n)] + [[]]
        sg.rcs = list(entries.end_rank.astype(np.int64)) + [INVALID]
        for i in range(n):
            node = sg.seg_start_node(i)
            sg.succ.setdefault(node, []).append(i)
        sg.next_id = n
        sg.count = n
        return sg

    def _alloc_id(self) -> int:
        i = self.next_id
        self.next_id = self.rcs[i] if i < len(self.rcs) else INVALID
        if self.next_id == INVALID:
            self.rcs.append(INVALID)
            self.segs.append([])
            self.next_id = len(self.rcs) - 1
        return i

    def _alloc_rc_ids(self) -> tuple[int, int]:
        fd = self._alloc_id()
        rc = self._alloc_id()
        self.rcs[fd] = rc
        self.rcs[rc] = fd
        return fd, rc

    def link(self, paths: list[int]) -> tuple[int, int]:
        """Concatenate superpaths into a new path + rc (``SuperGraph::link``)."""
        assert paths
        fd, rc = self._alloc_rc_ids()
        fd_segs: list[int] = []
        rc_segs: list[int] = []
        for p in paths:
            fd_segs.extend(self.segs[p])
            rc_segs[0:0] = self.segs[self.rcs[p]]
        self.segs[fd] = fd_segs
        self.segs[rc] = rc_segs
        self.succ.setdefault(self.start(fd), []).append(fd)
        self.succ.setdefault(self.start(rc), []).append(rc)
        self.count += 2
        return fd, rc

    def gap_path(self, length: int) -> int:
        fd, rc = self._alloc_rc_ids()
        s = make_gap_seg(length)
        self.segs[fd] = [s]
        self.segs[rc] = [s]
        self.count += 2
        return fd

    def erase(self, pid: int) -> None:
        rc_id = self.rcs[pid]
        self._half_erase(pid)
        if rc_id != pid:
            self._half_erase(rc_id)

    def _half_erase(self, pid: int) -> None:
        if not self.is_gap(pid):
            node = self.start(pid)
            ids = self.succ.get(node, [])
            if pid in ids:
                ids.remove(pid)
                if not ids:
                    self.succ.pop(node, None)
        self.segs[pid] = []
        # free the id (rcs doubles as free list)
        self.rcs[pid] = self.next_id
        self.next_id = pid
        self.count -= 1

    # -- persistence ------------------------------------------------------
    def write(self, basename: str, fac: FileFactory) -> None:
        name = basename + "-supergraph"
        write_header(fac, name, {"version": SUPERGRAPH_VERSION,
                                 "kind": "supergraph"})
        flat_segs = []
        seg_lens = []
        for s in self.segs:
            seg_lens.append(len(s))
            flat_segs.extend(s)
        write_array(fac, name + ".seg-lens",
                    np.array(seg_lens, dtype=np.int64))
        write_array(fac, name + ".segments",
                    np.array(flat_segs, dtype=np.uint64))
        write_array(fac, name + ".rcs", np.array(self.rcs, dtype=np.uint64))
        write_array(fac, name + ".meta",
                    np.array([self.next_id, self.count], dtype=np.uint64))

    def write_reference(self, basename: str, fac: FileFactory) -> None:
        """Write the reference's own ``.supergraph`` file set
        (``src/SuperGraph.cc:892-970``): raw little-endian MappedArrays
        — header/next-id/count u64, succ as (node u64-pair, count u32,
        path-id u64) triples, segs as per-id u32 counts + u64 tagged
        segments (encoding shared bit-for-bit with
        ``src/SuperPath.hh:45-98``), rcs as u64 — so supergraphs built
        here open in the original gossamer binaries."""
        name = basename + "-supergraph"

        def wbin(suffix, arr):
            with fac.open_write(name + suffix) as f:
                f.write(np.ascontiguousarray(arr).tobytes())

        wbin(".header", np.array([SUPERGRAPH_VERSION], np.uint64))
        wbin(".next-id", np.array([self.next_id], np.uint64))
        wbin(".count", np.array([self.count], np.uint64))
        nodes, nnum, nids = [], [], []
        for node, ids in self.succ.items():
            nodes.append((node & ((1 << 64) - 1), node >> 64))
            nnum.append(len(ids))
            nids.extend(ids)
        wbin(".succ.nodes", np.array(nodes, np.uint64).reshape(-1))
        wbin(".succ.num-path-ids", np.array(nnum, np.uint32))
        wbin(".succ.path-ids", np.array(nids, np.uint64))
        wbin(".segs.num-segments",
             np.array([len(s) for s in self.segs], np.uint32))
        wbin(".segs.segments",
             np.array([x for s in self.segs for x in s], np.uint64))
        wbin(".rcs.rc-path-ids", np.array(self.rcs, np.uint64))

    @classmethod
    def read_reference(cls, basename: str, fac: FileFactory,
                       entries: EntryEdgeSet) -> "SuperGraph":
        """Open a ``.supergraph`` file set written by the ORIGINAL
        gossamer binaries (``src/SuperGraph.cc:971-1062``)."""
        name = basename + "-supergraph"

        def rbin(suffix, dtype):
            with fac.open_read(name + suffix) as f:
                return np.frombuffer(f.read(), dtype=dtype)

        ver = int(rbin(".header", np.uint64)[0])
        if ver != SUPERGRAPH_VERSION:
            raise ValueError(f"unsupported supergraph version {ver}")
        sg = cls(entries)
        sg.next_id = int(rbin(".next-id", np.uint64)[0])
        sg.count = int(rbin(".count", np.uint64)[0])
        nums = rbin(".segs.num-segments", np.uint32)
        flat = rbin(".segs.segments", np.uint64)
        sg.segs = []
        off = 0
        for ln in nums:
            sg.segs.append([int(x) for x in flat[off : off + ln]])
            off += int(ln)
        sg.rcs = [int(x) for x in rbin(".rcs.rc-path-ids", np.uint64)]
        nodes = rbin(".succ.nodes", np.uint64)
        nnum = rbin(".succ.num-path-ids", np.uint32)
        nids = rbin(".succ.path-ids", np.uint64)
        off = 0
        for i in range(len(nnum)):
            node = (int(nodes[2 * i + 1]) << 64) | int(nodes[2 * i])
            sg.succ[node] = [int(x) for x in nids[off : off + int(nnum[i])]]
            off += int(nnum[i])
        return sg

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "SuperGraph":
        entries = EntryEdgeSet.read(basename, fac)
        name = basename + "-supergraph"
        with fac.open_read(name + ".header") as f:
            head = f.read()
        # the reference's file set starts with an 8-byte raw version
        # header; this package's header is a JSON artifact
        if not head.lstrip().startswith(b"{") and fac.exists(name + ".succ.nodes"):
            return cls.read_reference(basename, fac, entries)
        read_header(fac, name, SUPERGRAPH_VERSION)
        sg = cls(entries)
        seg_lens = read_array(fac, name + ".seg-lens")
        flat = read_array(fac, name + ".segments")
        sg.segs = []
        off = 0
        for ln in seg_lens:
            sg.segs.append([int(x) for x in flat[off : off + ln]])
            off += ln
        sg.rcs = [int(x) for x in read_array(fac, name + ".rcs")]
        meta = read_array(fac, name + ".meta")
        sg.next_id = int(meta[0])
        sg.count = int(meta[1])
        for pid in sg.path_ids():
            if not sg.is_gap(pid):
                sg.succ.setdefault(sg.start(pid), []).append(pid)
        return sg
