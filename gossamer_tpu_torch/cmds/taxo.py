"""Taxonomy-based k-mer annotation and read classification
(``gossamer_tpu/cmds/taxo.py``).

Counterpart of ``goss annotate-kmers`` / ``classify-reads``
(``src/GossCmdAnnotateKmers.cc``, ``src/GossCmdClassifyReads.cc:431+``,
``src/Phylogeny.{hh,cc}``, ``src/AnnotTree.{hh,cc}``): per-k-mer taxonomy
node annotations over a reference KmerSet, LCA binning of reads, and an
aggregated per-node count report.

Taxonomy file format (``<prefix>.taxo``): one node per line,
``node_id<TAB>parent_id<TAB>kind<TAB>name`` — the information content of
the reference's AnnotTree (whose parenthesized serialization we replace
with this TSV).

``classify-reads`` resolves each window's rank in the reference set on the
device (:func:`..classify.device.join_ranks_device`) up to k = 30 and on
the host above, as the JAX package does; the annotation gather and the
per-read LCA stay on the host.  Read ids come from the read starts, so a
window after an ``N`` stays with its read.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..cli.framework import Command, Context, add_input_options, iter_reads
from ..core import kmer as K
from ..graph.kmer_set import KmerSet
from ..io.artifacts import read_array, write_array
from ..io.factory import FileFactory
from ..utils import profile
from .more import _read_batches, _windows


class Phylogeny:
    """parent/kids maps + LCA (``src/Phylogeny.hh:25-120``)."""

    def __init__(self):
        self.parent: dict[int, int] = {}
        self.kind: dict[int, str] = {}
        self.name: dict[int, str] = {}
        self.kids: dict[int, list[int]] = defaultdict(list)
        self.root = 0

    @classmethod
    def read(cls, name: str, fac: FileFactory) -> "Phylogeny":
        ph = cls()
        for line in fac.read_text(name).splitlines():
            if not line.strip():
                continue
            nid, pid, kind, nm = line.split("\t", 3)
            nid, pid = int(nid), int(pid)
            ph.parent[nid] = pid
            ph.kind[nid] = kind
            ph.name[nid] = nm
            if nid == pid:
                ph.root = nid
            else:
                ph.kids[pid].append(nid)
        return ph

    def depth(self, n: int) -> int:
        d = 0
        while self.parent.get(n, n) != n:
            n = self.parent[n]
            d += 1
        return d

    def lca2(self, a: int, b: int) -> int:
        da, db = self.depth(a), self.depth(b)
        while da > db:
            a = self.parent[a]
            da -= 1
        while db > da:
            b = self.parent[b]
            db -= 1
        while a != b:
            if self.parent.get(a, a) == a and self.parent.get(b, b) == b:
                return 0
            a = self.parent.get(a, a)
            b = self.parent.get(b, b)
        return a

    def lca(self, nodes: set[int]) -> int:
        it = iter(nodes)
        n = next(it)
        for m in it:
            n = self.lca2(n, m)
            if n == 0:
                return 0
        return n


# ------------------------------------------------------------ annotate-kmers
def _annotate_opts(p):
    p.add_argument("-G", "--graph-in", required=True,
                   help="reference k-mer set")
    p.add_argument("--annot-list", required=True,
                   help="TSV: <input-file>\\t<taxonomy-node-id>")
    p.add_argument("--taxonomy", required=True,
                   help="taxonomy TSV (copied to <set>.taxo)")


def _annotate_run(ctx: Context) -> None:
    ref = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    annot = np.zeros(ref.count, dtype=np.uint32)
    ph = Phylogeny.read(ctx.opts.taxonomy, ctx.fac)
    from ..io.readers import read_file

    for line in ctx.fac.read_text(ctx.opts.annot_list).splitlines():
        if not line.strip():
            continue
        fname, node = line.rsplit("\t", 1)
        node = int(node)
        for rd in read_file(fname, ctx.fac):
            codes = K.encode_bases(rd.seq)
            n_win = len(codes) - ref.k + 1
            if n_win <= 0:
                continue
            lo = np.zeros(n_win, dtype=np.uint64)
            hi = np.zeros(n_win, dtype=np.uint64)
            valid = np.ones(n_win, dtype=bool)
            for j in range(ref.k):
                b = codes[j : j + n_win]
                valid &= b < 4
                hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
                lo = (lo << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
            nlo, nhi, _ = K.normalize(lo[valid], hi[valid], ref.k)
            hit, r = ref.access_and_rank(nlo, nhi)
            r = r[hit]
            # combine annotations: LCA of existing and new, one lca2 per
            # distinct existing annotation
            ur = np.unique(r)
            old = annot[ur]
            new = np.full(len(ur), node, dtype=annot.dtype)
            for v in np.unique(old[old > 0]):
                new[old == v] = ph.lca2(int(v), node)
            annot[ur] = new
    write_array(ctx.fac, ctx.opts.graph_in + ".annotation", annot)
    ctx.fac.write_text(ctx.opts.graph_in + ".taxo",
                       ctx.fac.read_text(ctx.opts.taxonomy))
    ctx.log("info", f"annotate-kmers: {int((annot > 0).sum())} kmers annotated")


# ------------------------------------------------------------ classify-reads
def _classify_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    add_input_options(p)


def _classify_run(ctx: Context) -> None:
    ref = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    ph = Phylogeny.read(ctx.opts.graph_in + ".taxo", ctx.fac)
    annot = read_array(ctx.fac, ctx.opts.graph_in + ".annotation")
    results: dict[int, int] = defaultdict(int)

    use_device = 2 * ref.k <= 62
    if use_device:
        from ..classify.device import join_ranks_device
        from ..convert import set_from_u64

        set_keys = set_from_u64(ref.lo, ctx.device)
    for buf in _read_batches(iter_reads(ctx)):
        with profile.context("classify/encode"):
            codes = [K.encode_bases(r.seq) for r in buf]
        if use_device:
            # sort-join rank resolution on device (the xenome engine
            # generalized to annotation-valued sets); annotation gather
            # stays host-side over the matched windows only
            rids, r = join_ranks_device(codes, set_keys, ref.k)
        else:
            lo, hi, valid, rid, _ = _windows(codes, ref.k)
            nlo, nhi, _f = K.normalize(lo, hi, ref.k)
            hit, r = ref.access_and_rank(nlo, nhi)
            hit &= valid
            r = r[hit]
            rids = rid[hit]
        with profile.context("classify/lca"):
            nodes = annot[r].astype(np.int64)
            keep = nodes > 0
            # the distinct (read, node) pairs, then one LCA per read
            pairs = np.unique((rids[keep] << 32) | nodes[keep])
            per_read: dict[int, set[int]] = defaultdict(set)
            for rr, nd in zip((pairs >> 32).tolist(),
                              (pairs & 0xFFFFFFFF).tolist()):
                per_read[rr].add(nd)
        for i in range(len(buf)):
            ns = per_read.get(i)
            results[ph.lca(ns) if ns else 0] += 1

    # aggregated report, counts summed up the tree
    # (GossCmdClassifyReads.cc counts())
    def walk(node: int) -> int:
        c = results.get(node, 0)
        s = c
        for kid in ph.kids.get(node, []):
            s += walk(kid)
        if s > 0:
            print(f"{s}\t{ph.kind.get(node, '?')}\t{ph.name.get(node, '?')}")
        return s

    walk(ph.root)
    if results.get(0):
        print(f"{results[0]}\tunclassified\tunclassified")


COMMANDS = [
    Command("annotate-kmers", "attach taxonomy annotations to a k-mer set",
            _annotate_opts, _annotate_run),
    Command("classify-reads", "taxonomic LCA binning of reads",
            _classify_opts, _classify_run),
]
