"""goss print-contigs (``gossamer_tpu/cmds/contigs_cmd.py``,
``src/GossCmdPrintContigs.cc:197-289``): supergraph contigs when the
graph has a supergraph beside it, linear-segment contigs otherwise."""

from __future__ import annotations

from ..algo.contigs import print_contigs
from ..cli.framework import Command, Context
from ..graph.graph import Graph


def _opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("--min-length", type=int, default=0)
    p.add_argument("-C", "--cutoff", type=int, default=0,
                   help="minimum coverage contig to print")
    p.add_argument("--no-sequence", action="store_true",
                   help="print a stats table instead of FASTA")
    p.add_argument("--verbose-headers", action="store_true")
    p.add_argument("--no-line-breaks", action="store_true")
    p.add_argument("--print-rcs", action="store_true")


def _run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    # supergraph-based contigs when present, linear segments otherwise
    # (GossCmdPrintContigs.cc:197-289)
    from ..algo.super_contigs import print_supergraph_contigs
    from ..graph.supergraph import SuperGraph, supergraph_exists

    if supergraph_exists(ctx.opts.graph_in, ctx.fac):
        sg = SuperGraph.read(ctx.opts.graph_in, ctx.fac)
        with ctx.fac.open_write_text(ctx.opts.output_file) as out:
            n = print_supergraph_contigs(
                sg, g, out,
                min_length=ctx.opts.min_length,
                omit_sequence=ctx.opts.no_sequence,
                verbose_headers=ctx.opts.verbose_headers,
                no_line_breaks=ctx.opts.no_line_breaks,
                print_rcs=ctx.opts.print_rcs,
            )
        ctx.log("info", f"print-contigs: {n} contigs (supergraph)")
        return
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        n = print_contigs(
            g,
            out,
            min_length=ctx.opts.min_length,
            min_coverage=ctx.opts.cutoff,
            omit_sequence=ctx.opts.no_sequence,
            verbose_headers=ctx.opts.verbose_headers,
            no_line_breaks=ctx.opts.no_line_breaks,
            print_rcs=ctx.opts.print_rcs,
        )
    ctx.log("info", f"print-contigs: {n} contigs")


COMMANDS = [
    Command("print-contigs", "print the contigs of a graph", _opts, _run),
]
