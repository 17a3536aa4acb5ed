"""goss assembly-stage commands (``gossamer_tpu/cmds/assembly.py``):
build-entry-edge-set, build-supergraph, thread-reads, thread-pairs."""

from __future__ import annotations

from ..cli.framework import Command, CommandError, Context
from ..graph.entry_edge_set import EntryEdgeSet
from ..graph.graph import Graph
from ..graph.supergraph import SuperGraph, supergraph_exists


def _graph_only(p):
    p.add_argument("-G", "--graph-in", required=True)


def _build_entries_run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    e = EntryEdgeSet.build(g)
    e.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"build-entry-edge-set: {e.count} entry edges")


def _build_supergraph_run(ctx: Context) -> None:
    e = EntryEdgeSet.read(ctx.opts.graph_in, ctx.fac)
    sg = SuperGraph.create(e)
    sg.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"build-supergraph: {sg.count} superpaths")


def _thread_reads_opts(p):
    from ..cli.framework import add_input_options

    _graph_only(p)
    add_input_options(p)
    p.add_argument("--min-link-count", type=int, default=10)
    p.add_argument("--expected-coverage", type=int, default=None)
    p.add_argument("--edge-cache-rate", type=int, default=4)


def _thread_reads_run(ctx: Context) -> None:
    import os

    import numpy as np

    from ..algo.threading import blocks_with_read_lengths, thread_reads
    from ..cli.framework import gather_read_files, iter_reads
    from ..io.factory import PhysicalFileFactory
    from ..io.native import native_or_none, native_read_blocks, read_lengths

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    # native path: plain on-disk inputs of one format stream as read-aligned
    # code blocks with no Python parsing.  One parser thread keeps the
    # blocks in file order, so the read lengths counted from the files tell
    # read ends from Ns (both are 255 in a block).
    reads = None
    files = gather_read_files(ctx)
    if (2 * g.rho <= 64 and isinstance(ctx.fac, PhysicalFileFactory)
            and all(os.path.exists(n) for n, _ in files)
            and len({f for _, f in files}) == 1):
        paths = [n for n, _ in files]
        blocks = native_or_none("read blocks", native_read_blocks, paths,
                                files[0][1], 1)
        if blocks is not None:
            lengths = np.concatenate(
                [read_lengths(p, files[0][1]) for p in paths])
            reads = ("flat", blocks_with_read_lengths(blocks, lengths))
    n = thread_reads(
        sg, g, reads if reads is not None else iter_reads(ctx, files),
        min_link_count=int(ctx.opts.min_link_count),
        expected_coverage=ctx.opts.expected_coverage,
        edge_cache_rate=int(ctx.opts.edge_cache_rate),
        num_threads=int(getattr(ctx.opts, "num_threads", 1) or 1),
        log=ctx.log,
    )
    sg.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"thread-reads: {n} joins")


def _thread_pairs_opts(p):
    from ..cli.framework import add_input_options

    _graph_only(p)
    add_input_options(p)
    p.add_argument("--min-link-count", type=int, default=10)
    p.add_argument("--expected-coverage", type=int, default=None)
    p.add_argument("--insert-expected-size", type=int, default=None)
    p.add_argument("--insert-size-std-dev", type=float, default=10.0)
    p.add_argument("--insert-size-tolerance", type=float, default=2.0)
    p.add_argument("--edge-cache-rate", type=int, default=4)
    p.add_argument("--paired-ends", action="store_true", default=True)
    p.add_argument("--innies", action="store_true")
    p.add_argument("--outies", action="store_true")
    p.add_argument("--mate-pairs", action="store_true")
    p.add_argument("--fill-gaps", action="store_true")
    p.add_argument("--consolidate-paths", action="store_true",
                   help="join ambiguous pairs along the gap-filled "
                        "consensus of all candidate paths "
                        "(GossCmdThreadPairs.cc:1277)")
    p.add_argument("--search-radius", type=int, default=10)


def _thread_pairs_run(ctx: Context) -> None:
    from ..algo.threading import thread_pairs
    from ..cli.framework import gather_read_files
    from ..io.readers import read_pair_files

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)
    if len(files) % 2:
        raise CommandError("thread-pairs needs an even number of read files")
    lhs = [n for n, _ in files[0::2]]
    rhs = [n for n, _ in files[1::2]]
    orient = "mate-pairs" if ctx.opts.mate_pairs else (
        "outies" if ctx.opts.outies else "paired-ends")
    n = thread_pairs(
        sg, g, read_pair_files(lhs, rhs, ctx.fac),
        orientation=orient,
        min_link_count=int(ctx.opts.min_link_count),
        insert_size=ctx.opts.insert_expected_size,
        insert_std_dev_pct=float(ctx.opts.insert_size_std_dev),
        insert_tolerance=float(ctx.opts.insert_size_tolerance),
        expected_coverage=ctx.opts.expected_coverage,
        fill_gaps=bool(ctx.opts.fill_gaps),
        consolidate_paths=bool(ctx.opts.consolidate_paths),
        search_radius=int(ctx.opts.search_radius),
        edge_cache_rate=int(ctx.opts.edge_cache_rate),
        num_threads=int(getattr(ctx.opts, "num_threads", 1) or 1),
        log=ctx.log,
    )
    sg.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"thread-pairs: {n} joins")


COMMANDS = [
    Command("build-entry-edge-set", "build the linear segment index",
            _graph_only, _build_entries_run),
    Command("build-supergraph", "initialize the supergraph",
            _graph_only, _build_supergraph_run),
    Command("thread-reads", "join superpaths using read spans",
            _thread_reads_opts, _thread_reads_run),
    Command("thread-pairs", "join superpaths using read pairs",
            _thread_pairs_opts, _thread_pairs_run),
]
