"""goss: detect-variants, extract-core-genome, fix-reads, build-db
(``gossamer_tpu/cmds/variants.py``).  Host code, as in the JAX package on
one device; ``build-db`` writes SQLite through the standard library."""

from __future__ import annotations

import numpy as np

from ..cli.framework import Command, CommandError, Context, add_input_options, iter_reads
from ..core import kmer as K
from ..graph.graph import Graph


# ------------------------------------------------------------ detect-variants
def _variants_opts(p):
    p.add_argument("--graph-ref", required=True)
    p.add_argument("--graph-target", required=True)
    p.add_argument("-o", "--output-file", default="-")


def _variants_run(ctx: Context) -> None:
    """Target edges absent from the reference whose from-node exists in
    the reference (``GossCmdDetectVariants.cc:31-59``)."""
    g = Graph.read(ctx.opts.graph_ref, ctx.fac)
    h = Graph.read(ctx.opts.graph_target, ctx.fac)
    hit, _ = g.access_and_rank(h.lo, h.hi)
    novel = ~hit
    flo, fhi = h.from_node(h.lo, h.hi)
    r0, r1 = g.begin_end_rank(flo, fhi)
    anchored = (r1 - r0) > 0
    sel = np.nonzero(novel & anchored)[0]
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        if len(sel):
            seqs = K.kmers_to_strings(h.rho, h.lo[sel], h.hi[sel])
            for i, s in enumerate(sel):
                out.write(f"{seqs[i].tobytes().decode()}\t{int(h.counts[s])}\n")
    ctx.log("info", f"detect-variants: {len(sel)} variant edges")


# ------------------------------------------------------- extract-core-genome
def _core_opts(p):
    p.add_argument("-G", "--graph-in", action="append", required=True)


def _core_run(ctx: Context) -> None:
    """Pairwise spectrum distances between graphs
    (``GossCmdExtractCoreGenome.cc:55-117``; the reference overwrites the
    accumulator each step — we sum, the documented intent)."""
    graphs = [Graph.read(n, ctx.fac) for n in ctx.opts.graph_in]
    totals = [float(g.counts.sum()) for g in graphs]
    names = ctx.opts.graph_in
    for i in range(len(graphs)):
        for j in range(i + 1, len(graphs)):
            a, b = graphs[i], graphs[j]
            hit_ab, r_ab = b.access_and_rank(a.lo, a.hi)
            fa = a.counts / totals[i]
            fb = b.counts / totals[j]
            d2 = 0.0
            # shared edges
            shared_b = r_ab[hit_ab]
            d2 += float(((fa[hit_ab] - fb[shared_b]) ** 2).sum())
            # a-only
            d2 += float((fa[~hit_ab] ** 2).sum())
            # b-only
            b_only = np.ones(b.count, dtype=bool)
            b_only[shared_b] = False
            d2 += float((fb[b_only] ** 2).sum())
            print(f"{names[i]}\t{names[j]}\t{d2:.6g}")


# ------------------------------------------------------------------ fix-reads
def _fix_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")
    add_input_options(p)


def _fix_run(ctx: Context) -> None:
    """Graph-guided read error correction (``GossCmdFixReads.cc:556-1276``):
    variable-k unique anchoring, probabilistic hit pairing with
    disjoint-set clustering, and greedy fragment assembly along linear
    segments (:mod:`..algo.fix_reads`).  Output is FASTA:
    corrected stretches uppercase from the graph, unfixed stretches
    lowercase from the read, header
    ``>label origLen,corrLen,nComps,nJuncs,[segs]``."""
    from ..algo.fix_reads import FixReadsEngine

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    if 2 * g.rho > 64:
        raise CommandError("fix-reads requires k <= 31 in this build")
    eng = FixReadsEngine(g, log=ctx.log)
    n_fixed = 0
    n_reads = 0
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        for rd in iter_reads(ctx):
            n_reads += 1
            label = rd.label.decode() if isinstance(rd.label, bytes) else rd.label
            fixed, n_comps, n_juncs, segs = eng.fix_read(bytes(rd.seq))
            if n_comps == 0:
                out.write(f">{label}\n{fixed}\n")
                continue
            n_fixed += 1
            seglist = ":".join(str(s) for s in segs)
            out.write(f">{label} {len(rd.seq)},{len(fixed)},"
                      f"{n_comps},{n_juncs},[{seglist}]\n{fixed}\n")
    ctx.log("info", f"fix-reads: corrected {n_fixed}/{n_reads} reads")


# ------------------------------------------------------------------- build-db
def _db_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", required=True,
                   help="SQLite database file")


def _db_run(ctx: Context) -> None:
    """SQLite export of supergraph contigs + links
    (schema from ``GossCmdBuildDb.cc:489-493``)."""
    import sqlite3

    from ..algo.super_contigs import _ChainIndex, path_contig
    from ..graph.supergraph import SuperGraph, supergraph_exists

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    if not supergraph_exists(ctx.opts.graph_in, ctx.fac):
        raise CommandError("build-db requires a supergraph")
    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    db = sqlite3.connect(ctx.opts.output_file)
    cur = db.cursor()
    cur.execute("CREATE TABLE IF NOT EXISTS version "
                "(version INTEGER, description TEXT);")
    cur.execute("CREATE TABLE IF NOT EXISTS nodes (id INTEGER PRIMARY KEY ASC,"
                " rc INTEGER, cov_mean REAL, length INTEGER);")
    cur.execute("CREATE TABLE IF NOT EXISTS links (id_from INTEGER, id_to "
                "INTEGER, gap INTEGER, count INTEGER, type INTEGER);")
    cur.execute("CREATE TABLE IF NOT EXISTS sequences (id INTEGER PRIMARY KEY"
                " ASC, sequence TEXT);")
    cur.execute("CREATE TABLE IF NOT EXISTS alignments (id INTEGER PRIMARY "
                "KEY ASC, name TEXT, start INTEGER, end INTEGER, matchLen "
                "INTEGER, dir INTEGER, gene TEXT);")
    cur.execute("INSERT INTO version VALUES (1, 'gossamer-tpu build-db');")
    ci = _ChainIndex(g)
    for pid in sorted(sg.path_ids()):
        if sg.is_gap(pid):
            continue
        seq, mn, mx, mean, std, _l, _s = path_contig(sg, g, ci, pid)
        cur.execute("INSERT INTO nodes VALUES (?, ?, ?, ?);",
                    (pid, sg.rc(pid), mean, len(seq)))
        cur.execute("INSERT INTO sequences VALUES (?, ?);", (pid, seq))
        end = sg.end(pid)
        if end is not None:
            for succ in sg.successors(end):
                cur.execute("INSERT INTO links VALUES (?, ?, ?, ?, ?);",
                            (pid, succ, 0, 0, 0))
    db.commit()
    db.close()
    ctx.log("info", f"build-db: wrote {ctx.opts.output_file}")


COMMANDS = [
    Command("detect-variants", "edges in target absent from reference",
            _variants_opts, _variants_run),
    Command("extract-core-genome", "pairwise spectrum distances",
            _core_opts, _core_run),
    Command("fix-reads", "graph-guided read error correction",
            _fix_opts, _fix_run),
    Command("build-db", "export supergraph to SQLite",
            _db_opts, _db_run),
]
