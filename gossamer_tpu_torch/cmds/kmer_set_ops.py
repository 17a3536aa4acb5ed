"""goss k-mer set algebra commands (``src/GossApp.cc:118-143``;
``gossamer_tpu/cmds/kmer_set_ops.py``).

The set algebra is host numpy; ``compute-near-kmers`` runs
:func:`..classify.annotated_set.compute_near_kmers` on ``--device``."""

from __future__ import annotations

from ..classify.annotated_set import (
    AnnotatedKmerSet,
    compute_near_kmers,
    intersect_sets,
    merge_and_annotate,
    merge_sets,
    subtract_sets,
)
from ..cli.framework import Command, CommandError, Context
from ..graph.kmer_set import KmerSet


def _two_in_one_out(p):
    p.add_argument("-G", "--graph-in", action="append", required=True,
                   help="input k-mer set (give twice)")
    p.add_argument("-O", "--graph-out", required=True)


def _many_in_one_out(p):
    p.add_argument("-G", "--graph-in", action="append", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _merge_run(ctx: Context) -> None:
    sets = [KmerSet.read(n, ctx.fac) for n in ctx.opts.graph_in]
    if len({s.k for s in sets}) != 1:
        raise CommandError("k-mer sets have differing K")
    merge_sets(sets).write(ctx.opts.graph_out, ctx.fac)


def _intersect_run(ctx: Context) -> None:
    names = ctx.opts.graph_in
    if len(names) != 2:
        raise CommandError("intersect-kmer-sets needs exactly two -G inputs")
    a = KmerSet.read(names[0], ctx.fac)
    b = KmerSet.read(names[1], ctx.fac)
    if a.k != b.k:
        raise CommandError("k-mer sets have differing K")
    intersect_sets(a, b).write(ctx.opts.graph_out, ctx.fac)


def _subtract_run(ctx: Context) -> None:
    names = ctx.opts.graph_in
    if len(names) != 2:
        raise CommandError("subtract-kmer-set needs exactly two -G inputs")
    a = KmerSet.read(names[0], ctx.fac)
    b = KmerSet.read(names[1], ctx.fac)
    if a.k != b.k:
        raise CommandError("k-mer sets have differing K")
    subtract_sets(a, b).write(ctx.opts.graph_out, ctx.fac)


def _merge_annotate_run(ctx: Context) -> None:
    names = ctx.opts.graph_in
    if len(names) != 2:
        raise CommandError("merge-and-annotate-kmer-sets needs two -G inputs")
    a = KmerSet.read(names[0], ctx.fac)
    b = KmerSet.read(names[1], ctx.fac)
    ann, common = merge_and_annotate(a, b)
    ann.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info",
            f"merge-and-annotate: {ann.kset.count} kmers, {common} common")


def _near_opts(p):
    p.add_argument("-G", "--graph-in", required=True,
                   help="annotated k-mer set (modified in place)")


def _near_run(ctx: Context) -> None:
    ann = AnnotatedKmerSet.read(ctx.opts.graph_in, ctx.fac)
    gray = compute_near_kmers(ann, ctx.device)
    ann.write(ctx.opts.graph_in, ctx.fac)
    ctx.log("info", f"compute-near-kmers: {gray} marginal kmers")


COMMANDS = [
    Command("merge-kmer-sets", "union of k-mer sets", _many_in_one_out, _merge_run),
    Command("intersect-kmer-sets", "intersection of two k-mer sets",
            _two_in_one_out, _intersect_run),
    Command("subtract-kmer-set", "difference of two k-mer sets",
            _two_in_one_out, _subtract_run),
    Command("merge-and-annotate-kmer-sets",
            "union of two k-mer sets with membership bits",
            _two_in_one_out, _merge_annotate_run),
    Command("compute-near-kmers", "mark marginal k-mers in an annotated set",
            _near_opts, _near_run),
]
