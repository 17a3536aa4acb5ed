"""goss print-contigs (``gossamer_tpu/cmds/contigs_cmd.py``,
``src/GossCmdPrintContigs.cc:197-289``).

Linear-segment contigs only: the supergraph is not ported yet, so a graph
that has a supergraph file beside it raises instead of printing linear
contigs in its place.
"""

from __future__ import annotations

from ..algo.contigs import print_contigs
from ..cli.framework import Command, CommandError, Context
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
    # the JAX package prints supergraph-based contigs when the file is there
    # (``graph/supergraph.py`` ``supergraph_exists``)
    if ctx.fac.exists(ctx.opts.graph_in + "-supergraph.header"):
        raise CommandError(
            f"{ctx.opts.graph_in}-supergraph.header is present: supergraph "
            f"contigs are not ported yet")
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
