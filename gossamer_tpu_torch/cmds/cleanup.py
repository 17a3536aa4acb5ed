"""goss cleanup commands: trim-graph, prune-tips, pop-bubbles
(``gossamer_tpu/cmds/cleanup.py``).

On one device all three are host code, as in the JAX package.  With
``--num-devices N`` above 1 they run on a mesh of N shards
(:func:`..parallel.mesh.data_mesh` on ``--device``, which raises when it
cannot give N): trim-graph's survivor mask, prune-tips' walks (narrow keys)
and pop-bubbles' linear segments (narrow keys).
"""

from __future__ import annotations

from ..algo.cleanup import prune_tips, trim_graph
from ..cli.framework import Command, Context
from ..graph.graph import Graph


def _graph_opts(p, mesh_help: str):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)
    p.add_argument("--num-devices", type=int, default=0, help=mesh_help)


def _mesh(ctx: Context, g: Graph, narrow_only: bool = True):
    """The mesh of ``--num-devices`` above 1, else None.  The mesh is made
    (and raises when the cards are short) before the graph's keys decide:
    a pass whose mesh form takes narrow keys only runs on the host for
    wide ones, as in the JAX package, and so does an empty graph."""
    n_dev = int(getattr(ctx.opts, "num_devices", 0) or 0)
    if n_dev <= 1:
        return None
    from ..parallel.mesh import data_mesh

    mesh = data_mesh(n_dev, ctx.device)
    if not g.count or (narrow_only and 2 * g.rho > 62):
        return None
    return mesh


def _trim_opts(p):
    _graph_opts(p, "compute the survivor mask on a mesh of N shards "
                   "(sharded edges + psum of the survivors)")
    p.add_argument("-C", "--cutoff", type=int, default=None,
                   help="drop edges with multiplicity below this")


def _trim_run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    cutoff = ctx.opts.cutoff
    if cutoff is None:
        # reference infers the cutoff from the coverage mixture model
        # (EstimateGraphStatistics)
        from ..algo.coverage import estimate_trim_cutoff

        mult, freq = g.hist()
        cutoff = estimate_trim_cutoff(mult, freq)
        ctx.log("info", f"trim-graph: inferred cutoff {cutoff}")
    mesh = _mesh(ctx, g, narrow_only=False)
    if mesh is not None:
        from ..parallel.cleanup_sharded import sharded_trim_mask

        keep, kept = sharded_trim_mask(mesh, g.counts, cutoff)
        g2 = g.remove_edges(~keep)
        if g2.count != kept:
            raise RuntimeError(f"trim-graph: the mesh counted {kept} "
                               f"survivors, its mask keeps {g2.count}")
    else:
        g2 = trim_graph(g, cutoff)
    ctx.log("info", f"trim-graph: {g.count - g2.count} edges removed "
                    f"({g2.count} remain)")
    g2.write(ctx.opts.graph_out, ctx.fac)


def _prune_opts(p):
    _graph_opts(p, "run the tip walks on a mesh of N shards (pointer "
                   "doubling over sharded edges; k <= 30)")
    p.add_argument("-C", "--cutoff", type=int, default=None)
    p.add_argument("--relative-cutoff", type=float, default=None)
    p.add_argument("--iterate", type=int, default=1,
                   help="repeat the pruning pass up to N times")


def _prune_run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    mesh = _mesh(ctx, g)
    if mesh is not None:
        from ..parallel.walk_sharded import sharded_prune_tips_masks

        dead = sharded_prune_tips_masks(
            mesh, g.lo, g.counts, g.rho,
            iterations=int(ctx.opts.iterate),
            cutoff=ctx.opts.cutoff,
            relative_cutoff=ctx.opts.relative_cutoff,
            log=ctx.log,
        )
        g2 = g.remove_edges(dead)
    else:
        g2 = prune_tips(
            g,
            iterations=int(ctx.opts.iterate),
            cutoff=ctx.opts.cutoff,
            relative_cutoff=ctx.opts.relative_cutoff,
            log=ctx.log,
        )
    g2.write(ctx.opts.graph_out, ctx.fac)


def _pop_opts(p):
    _graph_opts(p, "resolve TourBus pass 1's linear segments on a mesh of N "
                   "shards (pointer-doubling walks; k <= 30); pass 2 stays "
                   "on the host")
    p.add_argument("-C", "--cutoff", type=int, default=0)
    p.add_argument("--relative-cutoff", type=float, default=0.0)
    p.add_argument("--max-sequence-length", type=int, default=None,
                   help="max bubble branch length (default 2*rho+2)")
    p.add_argument("--max-edit-distance", type=int, default=None)
    p.add_argument("--max-relative-error", type=float, default=0.2)


def _pop_run(ctx: Context) -> None:
    from ..algo.tour_bus import pop_bubbles

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    g2, n_popped = pop_bubbles(
        g,
        cutoff=ctx.opts.cutoff,
        relative_cutoff=ctx.opts.relative_cutoff,
        max_sequence_length=ctx.opts.max_sequence_length,
        max_edit_distance=ctx.opts.max_edit_distance,
        max_relative_error=ctx.opts.max_relative_error,
        mesh=_mesh(ctx, g),
    )
    ctx.log("info", f"pop-bubbles: {n_popped} bubbles popped "
                    f"({g.count - g2.count} edges removed)")
    g2.write(ctx.opts.graph_out, ctx.fac)


COMMANDS = [
    Command("trim-graph", "remove low-coverage edges", _trim_opts, _trim_run),
    Command("prune-tips", "remove short dead-end paths", _prune_opts, _prune_run),
    Command("pop-bubbles", "remove bubbles (TourBus)", _pop_opts, _pop_run),
]
