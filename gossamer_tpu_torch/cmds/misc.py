"""goss: build-scaffold, scaffold, merge-graphs and count-components
(``gossamer_tpu/cmds/misc.py``)."""

from __future__ import annotations

import numpy as np

from ..cli.framework import Command, CommandError, Context, add_input_options, gather_read_files
from ..graph.graph import Graph
from ..graph.supergraph import SuperGraph


# ----------------------------------------------------------- build-scaffold
def _build_scaffold_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    add_input_options(p)
    p.add_argument("--insert-expected-size", type=int, default=None)
    p.add_argument("--expected-coverage", type=int, default=None)
    p.add_argument("--min-link-count", type=int, default=10)
    p.add_argument("--edge-cache-rate", type=int, default=4,
                   help="edge cache size as a proportion of edges "
                        "(1/2^rate of ranks anchor; GossApp.cc:171)")
    p.add_argument("--scaffold-lib", default=None,
                   help="library name (defaults to first input file)")
    p.add_argument("--paired-ends", action="store_true", default=True)
    p.add_argument("--innies", action="store_true")
    p.add_argument("--outies", action="store_true")
    p.add_argument("--mate-pairs", action="store_true")


def _build_scaffold_run(ctx: Context) -> None:
    from ..algo.scaffold import ScaffoldGraph, build_scaffold
    from ..io.readers import read_pair_files

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)
    if len(files) % 2:
        raise CommandError("build-scaffold needs an even number of read files")
    lhs = [n for n, _ in files[0::2]]
    rhs = [n for n, _ in files[1::2]]
    orient = "mate-pairs" if ctx.opts.mate_pairs else (
        "outies" if ctx.opts.outies else "paired-ends")
    sc = build_scaffold(
        sg, g, read_pair_files(lhs, rhs, ctx.fac),
        orientation=orient,
        insert_size=ctx.opts.insert_expected_size,
        expected_coverage=ctx.opts.expected_coverage,
        min_link_count=int(ctx.opts.min_link_count),
        edge_cache_rate=int(ctx.opts.edge_cache_rate),
        log=ctx.log,
    )
    sc.orientation = orient
    lib = ScaffoldGraph.next_lib(ctx.opts.graph_in, ctx.fac)
    sc.write(ctx.opts.graph_in, lib, ctx.fac)
    label = ctx.opts.scaffold_lib or lhs[0]
    ctx.log("info", f"build-scaffold: {len(sc.links)} links "
                    f"(-scaf.{lib}, library {label})")


def _scaffold_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("--min-link-count", type=int, default=10)


def _scaffold_run(ctx: Context) -> None:
    from ..algo.scaffold import ScaffoldGraph, scaffold

    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    libs = ScaffoldGraph.libs(ctx.opts.graph_in, ctx.fac)
    if not libs:
        raise CommandError("no scaffold libraries (run build-scaffold first)")
    scafs = [ScaffoldGraph.read(ctx.opts.graph_in, lib, ctx.fac) for lib in libs]
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    n = scaffold(sg, scafs, g=g, min_link_count=int(ctx.opts.min_link_count),
                 log=ctx.log)
    sg.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"scaffold: {n} joins")


# --------------------------------------------------------------- merge-graphs
def _merge_graphs_opts(p):
    p.add_argument("-G", "--graph-in", action="append", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _merge_graphs_run(ctx: Context) -> None:
    """K-way merge of graphs, counts summed (``GossCmdMerge.tcc:210-324``)."""
    graphs = [Graph.read(n, ctx.fac) for n in ctx.opts.graph_in]
    ks = {g.k for g in graphs}
    if len(ks) != 1:
        raise CommandError("graphs have differing K")
    lo = np.concatenate([g.lo for g in graphs])
    hi = np.concatenate([g.hi for g in graphs])
    c = np.concatenate([g.counts for g in graphs])
    order = np.lexsort((lo, hi))
    lo, hi, c = lo[order], hi[order], c[order]
    if len(lo):
        new = np.ones(len(lo), dtype=bool)
        new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        idx = np.cumsum(new) - 1
        out_c = np.zeros(int(idx[-1]) + 1, dtype=c.dtype)
        np.add.at(out_c, idx, c)
        lo, hi, c = lo[new], hi[new], out_c
    Graph(graphs[0].k, lo, hi, c, graphs[0].asymmetric).write(
        ctx.opts.graph_out, ctx.fac)


# ------------------------------------------------------------ count-components
def _count_components_opts(p):
    p.add_argument("-G", "--graph-in", required=True)


def _count_components_run(ctx: Context) -> None:
    """Weakly-connected component count (``GossCmdCountComponents.cc``),
    via union-find over edge endpoints."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    flo, fhi = g.from_node(g.lo, g.hi)
    tlo, thi = g.to_node(g.lo, g.hi)
    # index nodes
    nodes_lo = np.concatenate([flo, tlo])
    nodes_hi = np.concatenate([fhi, thi])
    order = np.lexsort((nodes_lo, nodes_hi))
    nl, nh = nodes_lo[order], nodes_hi[order]
    keep = np.ones(len(nl), dtype=bool)
    keep[1:] = (nl[1:] != nl[:-1]) | (nh[1:] != nh[:-1])
    ul, uh = nl[keep], nh[keep]
    from ..graph.kmer_set import rank128

    fi = rank128(ul, uh, flo, fhi)
    ti = rank128(ul, uh, tlo, thi)
    parent = np.arange(len(ul), dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(fi, ti):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = len({int(find(i)) for i in range(len(ul))})
    print(roots)
    ctx.log("info", f"count-components: {roots} components")


COMMANDS = [
    Command("build-scaffold", "map a pair library onto the supergraph",
            _build_scaffold_opts, _build_scaffold_run),
    Command("scaffold", "linearize scaffold links with gap paths",
            _scaffold_opts, _scaffold_run),
    Command("merge-graphs", "merge graphs, summing counts",
            _merge_graphs_opts, _merge_graphs_run),
    Command("count-components", "count weakly connected components",
            _count_components_opts, _count_components_run),
]
