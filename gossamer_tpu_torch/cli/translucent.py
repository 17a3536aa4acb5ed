"""``translucent`` — transcriptome assembly (reference ``src/TranslucentApp.cc``;
``gossamer_tpu/cli/translucent.py``).

    python -m gossamer_tpu_torch.cli.translucent assemble -G g -i r1.fq -i r2.fq

Shares the goss command set (build/trim/prune/pop/entries/supergraph) and
adds ``trim-relative`` (``src/TransCmdTrimRelative.cc``),
``merge-graph-with-reference`` (``src/TransCmdMergeGraphWithReference.cc``)
and ``assemble`` (``src/TransCmdAssemble.cc`` driving
``src/ResolveTranscripts.cc``: per-component transcript extraction).
Every command takes ``--device`` (default ``cuda``); ``build-graph`` and
``build-kmer-set`` run their count on it, the rest is host code.
"""

from __future__ import annotations

import numpy as np

from ..cli.framework import App, Command, Context, add_input_options, iter_reads
from ..cmds import all_goss_commands
from ..graph.graph import Graph


def _trim_relative_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)
    p.add_argument("--relative-cutoff", type=float, default=0.05)


def _trim_relative_run(ctx: Context) -> None:
    """Per-node relative coverage cull (``TransCmdTrimRelative.cc:80-119``):
    among each node's out-edges, drop those with count < total * cutoff
    (plus reverse complements)."""
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    n = g.count
    if n == 0:
        g.write(ctx.opts.graph_out, ctx.fac)
        return
    flo, fhi = g.from_node(g.lo, g.hi)
    new_grp = np.ones(n, dtype=bool)
    new_grp[1:] = (flo[1:] != flo[:-1]) | (fhi[1:] != fhi[:-1])
    grp = np.cumsum(new_grp) - 1
    totals = np.zeros(int(grp[-1]) + 1, dtype=np.float64)
    np.add.at(totals, grp, g.counts.astype(np.float64))
    thresh = totals[grp] * float(ctx.opts.relative_cutoff)
    zap = g.counts < thresh
    zap |= zap[g.edge_rc_rank()]
    g2 = g.remove_edges(zap)
    g2.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"trim-relative: removed {g.count - g2.count} edges")


def _merge_ref_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("--graph-ref", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _merge_ref_run(ctx: Context) -> None:
    """Intersect graph with a reference graph, keeping the reference's
    counts (``TransCmdMergeGraphWithReference.cc:44-107``)."""
    from ..cli.framework import CommandError

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    ref = Graph.read(ctx.opts.graph_ref, ctx.fac)
    if g.k != ref.k:
        raise CommandError(
            f"graphs involved in a merge must have the same kmer-size "
            f"({ctx.opts.graph_in} has k={g.k}, {ctx.opts.graph_ref} has "
            f"k={ref.k})")
    if g.asymmetric != ref.asymmetric:
        raise CommandError("graphs must both preserve sense or neither")
    hit, r = ref.access_and_rank(g.lo, g.hi)
    sel = np.nonzero(hit)[0]
    Graph(g.k, g.lo[sel], g.hi[sel], ref.counts[r[sel]], g.asymmetric).write(
        ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"merge-graph-with-reference: {len(sel)} edges kept")


def _assemble_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")
    add_input_options(p)
    p.add_argument("--min-length", type=int, default=200)
    p.add_argument("--min-link-count", type=int, default=2)
    p.add_argument("--expected-coverage", type=int, default=None)


def _assemble_run(ctx: Context) -> None:
    """Per-component transcript extraction — contig welding, read-pair
    routing and read-guided path resolution
    (``TransCmdAssemble.cc:1393-1770`` + ``ResolveTranscripts.cc``,
    see :mod:`..algo.transcripts`).

    Paired inputs follow the thread-pairs convention: an even number of
    read files pairs them in lockstep (``ReadPairSequenceFileSequence``);
    otherwise consecutive reads of the stream form pairs (interleaved).
    """
    from ..algo.transcripts import assemble_transcripts
    from ..cli.framework import gather_read_files
    from ..core import kmer as K
    from ..io.readers import read_pair_files

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)  # raises CommandError on a bad -I path
    if len(files) >= 2 and len(files) % 2 == 0:
        lhs = [n for n, _ in files[0::2]]
        rhs = [n for n, _ in files[1::2]]
        pair_iter = ((K.encode_bases(a.seq), K.encode_bases(b.seq))
                     for a, b in read_pair_files(lhs, rhs, ctx.fac))
    else:
        def _interleaved():
            it = iter_reads(ctx, files)
            for a in it:
                b = next(it, None)
                if b is None:
                    break
                yield K.encode_bases(a.seq), K.encode_bases(b.seq)
        pair_iter = _interleaved()
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        assemble_transcripts(g, pair_iter, out,
                             min_length=int(ctx.opts.min_length),
                             log=ctx.log)


def build_app() -> App:
    app = App("translucent", "translucent — transcriptome assembler (gossamer-tpu, PyTorch port)")
    for cmd in all_goss_commands():
        app.register(cmd)
    app.register(Command("trim-relative", "relative per-node coverage trim",
                         _trim_relative_opts, _trim_relative_run))
    app.register(Command("merge-graph-with-reference",
                         "intersect with a reference graph's coverage",
                         _merge_ref_opts, _merge_ref_run))
    app.register(Command("assemble", "assemble transcripts",
                         _assemble_opts, _assemble_run))
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
