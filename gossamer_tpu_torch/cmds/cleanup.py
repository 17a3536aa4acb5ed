"""goss cleanup commands: trim-graph, prune-tips, pop-bubbles
(``gossamer_tpu/cmds/cleanup.py``).

All three are host code on one device, as in the JAX package; its mesh
forms (``--num-devices`` > 1) are not ported yet and raise.
"""

from __future__ import annotations

from ..algo.cleanup import prune_tips, trim_graph
from ..cli.framework import Command, CommandError, Context
from ..graph.graph import Graph


def _graph_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)
    p.add_argument("--num-devices", type=int, default=0,
                   help="run on an N-device mesh (not ported yet: more "
                        "than one device raises)")


def _one_device(ctx: Context, name: str) -> None:
    n_dev = int(getattr(ctx.opts, "num_devices", 0) or 0)
    if n_dev > 1:
        raise CommandError(f"--num-devices {n_dev}: {name} across several "
                           f"devices is not ported yet")


def _trim_opts(p):
    _graph_opts(p)
    p.add_argument("-C", "--cutoff", type=int, default=None,
                   help="drop edges with multiplicity below this")


def _trim_run(ctx: Context) -> None:
    _one_device(ctx, "trim-graph")
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    cutoff = ctx.opts.cutoff
    if cutoff is None:
        # reference infers the cutoff from the coverage mixture model
        # (EstimateGraphStatistics)
        from ..algo.coverage import estimate_trim_cutoff

        mult, freq = g.hist()
        cutoff = estimate_trim_cutoff(mult, freq)
        ctx.log("info", f"trim-graph: inferred cutoff {cutoff}")
    g2 = trim_graph(g, cutoff)
    ctx.log("info", f"trim-graph: {g.count - g2.count} edges removed "
                    f"({g2.count} remain)")
    g2.write(ctx.opts.graph_out, ctx.fac)


def _prune_opts(p):
    _graph_opts(p)
    p.add_argument("-C", "--cutoff", type=int, default=None)
    p.add_argument("--relative-cutoff", type=float, default=None)
    p.add_argument("--iterate", type=int, default=1,
                   help="repeat the pruning pass up to N times")


def _prune_run(ctx: Context) -> None:
    _one_device(ctx, "prune-tips")
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    g2 = prune_tips(
        g,
        iterations=int(ctx.opts.iterate),
        cutoff=ctx.opts.cutoff,
        relative_cutoff=ctx.opts.relative_cutoff,
        log=ctx.log,
    )
    g2.write(ctx.opts.graph_out, ctx.fac)


def _pop_opts(p):
    _graph_opts(p)
    p.add_argument("-C", "--cutoff", type=int, default=0)
    p.add_argument("--relative-cutoff", type=float, default=0.0)
    p.add_argument("--max-sequence-length", type=int, default=None,
                   help="max bubble branch length (default 2*rho+2)")
    p.add_argument("--max-edit-distance", type=int, default=None)
    p.add_argument("--max-relative-error", type=float, default=0.2)


def _pop_run(ctx: Context) -> None:
    from ..algo.tour_bus import pop_bubbles

    _one_device(ctx, "pop-bubbles")
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    g2, n_popped = pop_bubbles(
        g,
        cutoff=ctx.opts.cutoff,
        relative_cutoff=ctx.opts.relative_cutoff,
        max_sequence_length=ctx.opts.max_sequence_length,
        max_edit_distance=ctx.opts.max_edit_distance,
        max_relative_error=ctx.opts.max_relative_error,
    )
    ctx.log("info", f"pop-bubbles: {n_popped} bubbles popped "
                    f"({g.count - g2.count} edges removed)")
    g2.write(ctx.opts.graph_out, ctx.fac)


COMMANDS = [
    Command("trim-graph", "remove low-coverage edges", _trim_opts, _trim_run),
    Command("prune-tips", "remove short dead-end paths", _prune_opts, _prune_run),
    Command("pop-bubbles", "remove bubbles (TourBus)", _pop_opts, _pop_run),
]
