"""goss long-tail commands: read extraction/filtering, subgraphs,
path trimming, dot output, edge index, error estimation, upgrades
(``gossamer_tpu/cmds/more.py``).

Host code, as in the JAX package on one device.  The read windows of
``extract-reads`` and ``filter-reads`` (and of ``classify-reads`` above
k = 30 and ``espresso``, which import :func:`_windows` from here) take
their read ids from the read starts (:func:`..algo.threading._window_kmers`),
so a window after an ``N`` stays with its read.
"""

from __future__ import annotations

import numpy as np

from ..cli.framework import (
    Command,
    CommandError,
    Context,
    add_input_options,
    iter_reads,
)
from ..classify.xenome import print_read
from ..core import kmer as K
from ..graph.graph import Graph
from ..graph.kmer_set import KmerSet
from ..graph.segments import decompose


def _windows(codes_list, k):
    """Flat k-windows of a batch of reads: (lo, hi, valid, read id,
    position in the read), the read id taken from the read starts."""
    from ..algo.threading import _window_kmers

    return _window_kmers(codes_list, k)


def _read_batches(reads, batch=4096):
    buf = []
    for rd in reads:
        buf.append(rd)
        if len(buf) >= batch:
            yield buf
            buf = []
    if buf:
        yield buf


# ------------------------------------------------------------- extract-reads
def _extract_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")
    add_input_options(p)


def _extract_run(ctx: Context) -> None:
    """Reads with any rho-mer in the graph (``GossCmdExtractReads.cc:93-108``)."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    n = m = 0
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        for buf in _read_batches(iter_reads(ctx)):
            codes = [K.encode_bases(r.seq) for r in buf]
            lo, hi, valid, rid, _ = _windows(codes, g.rho)
            hit, _r = g.access_and_rank(lo, hi)
            hit &= valid
            matched = np.zeros(len(buf), dtype=bool)
            np.logical_or.at(matched, rid[hit], True)
            for rd, ok in zip(buf, matched):
                n += 1
                if ok:
                    m += 1
                    print_read(out, rd)
    ctx.log("info", f"extracted {m} reads, out of {n}")


# ------------------------------------------------------------- filter-reads
def _filter_opts(p):
    p.add_argument("-G", "--graph-in", required=True,
                   help="k-mer set to filter against")
    add_input_options(p)
    p.add_argument("--pairs", action="store_true")
    p.add_argument("--match-file", default=None)
    p.add_argument("--non-match-file", default=None)


def _filter_run(ctx: Context) -> None:
    """Split reads by k-mer-set membership (``GossCmdFilterReads.cc``).

    Note: the reference kmerizes at K+1 against a K-sized set
    (``GossCmdFilterReads.cc:48``) which can never match for canonical
    sets; we use K windows (raw or rc), the documented intent.
    """
    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    match_out = ctx.fac.open_write_text(ctx.opts.match_file) if ctx.opts.match_file else None
    non_out = ctx.fac.open_write_text(ctx.opts.non_match_file) if ctx.opts.non_match_file else None
    if match_out is None and non_out is None:
        raise CommandError("filter-reads: give --match-file and/or --non-match-file")
    n = m = 0
    try:
        for buf in _read_batches(iter_reads(ctx)):
            codes = [K.encode_bases(r.seq) for r in buf]
            lo, hi, valid, rid, _ = _windows(codes, ks.k)
            hit, _r = ks.access_and_rank(lo, hi)
            rlo, rhi = K.reverse_complement(lo, hi, ks.k)
            hit_rc, _r2 = ks.access_and_rank(rlo, rhi)
            hit = (hit | hit_rc) & valid
            matched = np.zeros(len(buf), dtype=bool)
            np.logical_or.at(matched, rid[hit], True)
            for rd, ok in zip(buf, matched):
                n += 1
                if ok:
                    m += 1
                    if match_out:
                        print_read(match_out, rd)
                elif non_out:
                    print_read(non_out, rd)
    finally:
        if match_out:
            match_out.close()
        if non_out:
            non_out.close()
    ctx.log("info", f"filter-reads: {m}/{n} matched")


# ------------------------------------------------------------ build-subgraph
def _subgraph_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)
    add_input_options(p)
    p.add_argument("--radius", type=int, default=1)
    p.add_argument("--linear-paths", action="store_true")


def _subgraph_run(ctx: Context) -> None:
    """Neighborhood extraction (``GossCmdBuildSubgraph.cc:133-210``)."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    interesting = np.zeros(g.count, dtype=bool)
    for buf in _read_batches(iter_reads(ctx)):
        codes = [K.encode_bases(r.seq) for r in buf]
        lo, hi, valid, _rid, _ = _windows(codes, g.rho)
        rlo, rhi = K.reverse_complement(lo, hi, g.rho)
        for qlo, qhi in ((lo, hi), (rlo, rhi)):
            hit, r = g.access_and_rank(qlo, qhi)
            hit &= valid
            interesting[r[hit]] = True
    rc_rank = g.edge_rc_rank()
    for _ in range(int(ctx.opts.radius)):
        sel = np.nonzero(interesting)[0]
        tlo, thi = g.to_node(g.lo[sel], g.hi[sel])
        r0, r1 = g.begin_end_rank(tlo, thi)
        for j in range(4):
            idx = r0 + j
            live = idx < r1
            interesting[np.minimum(idx, g.count - 1)[live]] = True
        interesting[rc_rank[sel]] = True
    if ctx.opts.linear_paths:
        dec = decompose(g)
        seg_hit = np.zeros(len(dec.seg_start), dtype=bool)
        seg_of = np.searchsorted(dec.seg_off, np.arange(len(dec.order)),
                                 side="right") - 1
        edge_seg = np.full(g.count, -1, dtype=np.int64)
        edge_seg[dec.order] = seg_of
        sel = np.nonzero(interesting & (edge_seg >= 0))[0]
        seg_hit[edge_seg[sel]] = True
        for s in np.nonzero(seg_hit)[0]:
            off = dec.seg_off[s]
            interesting[dec.order[off : off + dec.seg_len[s]]] = True
    sel = np.nonzero(interesting)[0]
    Graph(g.k, g.lo[sel], g.hi[sel], g.counts[sel], g.asymmetric).write(
        ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"build-subgraph: {len(sel)} edges")


# --------------------------------------------------------------- trim-paths
def _trim_paths_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)
    p.add_argument("-C", "--cutoff", type=int, required=True)


def _trim_paths_run(ctx: Context) -> None:
    """Remove whole linear paths with mean coverage below the cutoff
    (``GossCmdTrimPaths.cc``)."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    dec = decompose(g)
    if len(dec.seg_start) == 0:
        g.write(ctx.opts.graph_out, ctx.fac)
        return
    sums = np.zeros(len(dec.seg_start), dtype=np.float64)
    seg_of = np.searchsorted(dec.seg_off, np.arange(len(dec.order)), side="right") - 1
    np.add.at(sums, seg_of, g.counts[dec.order].astype(np.float64))
    means = sums / np.maximum(dec.seg_len, 1)
    kill = means < ctx.opts.cutoff
    zap = np.zeros(g.count, dtype=bool)
    kill_edges = dec.order[kill[seg_of]]
    zap[kill_edges] = True
    zap[g.edge_rc_rank()[kill_edges]] = True
    g2 = g.remove_edges(zap)
    g2.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"trim-paths: removed {int(kill.sum())} paths "
                    f"({g.count - g2.count} edges)")


# ----------------------------------------------------------------- dot-graph
def _dot_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("--label-edges", action="store_true")


def _dot_graph_run(ctx: Context) -> None:
    """Graphviz rendering (``GossCmdDotGraph.cc``)."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    flo, fhi = g.from_node(g.lo, g.hi)
    tlo, thi = g.to_node(g.lo, g.hi)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        out.write("digraph G {\n")
        f_str = K.kmers_to_strings(g.k, flo, fhi)
        t_str = K.kmers_to_strings(g.k, tlo, thi)
        for i in range(g.count):
            a = f_str[i].tobytes().decode()
            b = t_str[i].tobytes().decode()
            lbl = f' [label="{int(g.counts[i])}"]' if ctx.opts.label_edges else ""
            out.write(f'  "{a}" -> "{b}"{lbl};\n')
        out.write("}\n")


def _dot_supergraph_run(ctx: Context) -> None:
    from ..graph.supergraph import SuperGraph

    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        out.write("digraph SG {\n")
        for pid in sorted(sg.path_ids()):
            if sg.is_gap(pid):
                continue
            s = sg.start(pid)
            e = sg.end(pid)
            lbl = f' [label="{pid} ({sg.size(pid)})"]' if ctx.opts.label_edges else f' [label="{pid}"]'
            out.write(f'  "n{s:x}" -> "n{e:x}"{lbl};\n')
        out.write("}\n")


# -------------------------------------------------------------- upgrade-graph
def _upgrade_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("--format", choices=("native", "reference"),
                   default="native",
                   help="output format: this build's arrays, or the "
                        "reference's Elias-Fano/VariableByteArray file "
                        "set (opens in the original gossamer)")


def _upgrade_run(ctx: Context) -> None:
    """Re-write an artifact under the current format version
    (``GossCmdUpgradeGraph.cc``).  Interop runs BOTH directions:
    REFERENCE-format graphs (read via
    :mod:`..io.reference_format`) convert into this build's
    format, and ``--format reference`` writes the reference's own
    binary file set (:mod:`..io.reference_write`,
    byte-identical to the reference's Builders), so artifacts flow
    freely between the two implementations."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    if ctx.opts.format == "reference":
        from ..io.reference_write import write_reference_graph

        write_reference_graph(ctx.fac, ctx.opts.graph_in, g.k,
                              np.asarray(g.lo), np.asarray(g.hi),
                              np.asarray(g.counts),
                              asymmetric=g.asymmetric)
        ctx.log("info", "upgrade-graph: rewritten in reference format")
        return
    g.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", "upgrade-graph: rewritten at current version")


# ------------------------------------------------------------ build-edge-index
def _edge_index_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("--edge-cache-rate", type=int, default=4,
                   help="subsample 1/2^rate edge ranks "
                        "(GossCmdBuildEdgeIndex.cc:72)")


def _edge_index_run(ctx: Context) -> None:
    """Persist the edge -> (segment, offset) anchoring table
    (``src/EdgeIndex.cc:288``), subsampled at ``--edge-cache-rate``."""
    from ..graph.supergraph import SuperGraph
    from ..algo.threading import PathIndex
    from ..io.artifacts import write_array, write_header

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    idx = PathIndex(g, sg, int(ctx.opts.edge_cache_rate))
    name = ctx.opts.graph_in + "-edge-index"
    write_header(ctx.fac, name, {"version": 1, "kind": "edge-index",
                                 "div": int(ctx.opts.edge_cache_rate)})
    write_array(ctx.fac, name + ".edge-seg", idx.edge_seg)
    write_array(ctx.fac, name + ".edge-off", idx.edge_off)
    write_array(ctx.fac, name + ".seg-path", idx.seg_path)
    write_array(ctx.fac, name + ".seg-path-off", idx.seg_path_off)
    ctx.log("info", f"build-edge-index: {len(idx.edge_seg)} ranks stored "
                    f"(1/{1 << int(ctx.opts.edge_cache_rate)} of "
                    f"{g.count} edges)")


# ------------------------------------------------------------ estimate-errors
def _estimate_errors_opts(p):
    p.add_argument("-G", "--graph-in", required=True)


def _estimate_errors_run(ctx: Context) -> None:
    """Coverage-model error estimate (``GossCmdEstimateErrors.cc`` /
    ``EstimateGraphStatistics``): reports the inferred error-edge mass
    and rho-mer coverage from the count histogram."""
    from ..algo.coverage import estimate_coverage, estimate_trim_cutoff

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    mult, freq = g.hist()
    cov = estimate_coverage(mult, freq)
    cutoff = estimate_trim_cutoff(mult, freq)
    total = int((mult * freq).sum()) if len(mult) else 0
    err_mass = int((mult[mult < cutoff] * freq[mult < cutoff]).sum()) if len(mult) else 0
    rate = err_mass / total if total else 0.0
    print(f"estimated-coverage\t{cov}")
    print(f"error-cutoff\t{cutoff}")
    print(f"error-mass-fraction\t{rate:.6g}")


# ---------------------------------------------------------------- clip-links
def _clip_links_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-C", "--cutoff", type=int, default=10)


def _clip_links_run(ctx: Context) -> None:
    """Drop weak scaffold links (``GossCmdClipLinks.cc``)."""
    from ..algo.scaffold import ScaffoldGraph

    n_drop = 0
    for lib in ScaffoldGraph.libs(ctx.opts.graph_in, ctx.fac):
        sc = ScaffoldGraph.read(ctx.opts.graph_in, lib, ctx.fac)
        before = len(sc.links)
        sc.links = {l: v for l, v in sc.links.items() if v[0] >= ctx.opts.cutoff}
        n_drop += before - len(sc.links)
        sc.write(ctx.opts.graph_in, lib, ctx.fac)
    ctx.log("info", f"clip-links: dropped {n_drop} links")


# --------------------------------------------------------------- pool-samples
def _pool_opts(p):
    p.add_argument("-G", "--graph-in", action="append", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _pool_run(ctx: Context) -> None:
    """Pool per-sample k-mer sets into a union set with per-sample
    presence columns (``GossCmdPoolSamples.cc`` / espresso substrate)."""
    from ..classify.electus import RefMaskSet
    from ..io.artifacts import write_array, write_header

    sets = [KmerSet.read(n, ctx.fac) for n in ctx.opts.graph_in]
    refs = RefMaskSet.build(sets)
    refs.union.write(ctx.opts.graph_out, ctx.fac)
    write_array(ctx.fac, ctx.opts.graph_out + ".sample-mask", refs.mask)
    ctx.log("info", f"pool-samples: {refs.union.count} kmers x {len(sets)} samples")


COMMANDS = [
    Command("extract-reads", "extract reads matching a graph",
            _extract_opts, _extract_run),
    Command("filter-reads", "split reads by k-mer set membership",
            _filter_opts, _filter_run),
    Command("build-subgraph", "extract a neighborhood subgraph",
            _subgraph_opts, _subgraph_run),
    Command("trim-paths", "remove low-coverage linear paths",
            _trim_paths_opts, _trim_paths_run),
    Command("dot-graph", "emit the graph in Graphviz format",
            _dot_opts, _dot_graph_run),
    Command("dot-supergraph", "emit the supergraph in Graphviz format",
            _dot_opts, _dot_supergraph_run),
    Command("upgrade-graph", "rewrite a graph at the current version",
            _upgrade_opts, _upgrade_run),
    Command("build-edge-index", "persist the read-anchoring edge index",
            _edge_index_opts, _edge_index_run),
    Command("estimate-errors", "estimate error content from the histogram",
            _estimate_errors_opts, _estimate_errors_run),
    Command("clip-links", "drop weak scaffold links",
            _clip_links_opts, _clip_links_run),
    Command("pool-samples", "pool k-mer sets with per-sample presence",
            _pool_opts, _pool_run),
]
