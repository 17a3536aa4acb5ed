"""``xenome`` of the port — xenograft read classifier (reference
``src/XenoApp.cc``; ``gossamer_tpu/cli/xenome.py``).

    python -m gossamer_tpu_torch.cli.xenome index -K 25 -G graft.fa -H host.fa -P idx
    python -m gossamer_tpu_torch.cli.xenome classify -P idx -i reads.fastq

Commands:
  index     build graft/host index (build-kmer-set x2 ->
            merge-and-annotate -> compute-near-kmers, ``XenoApp.cc:49-135``)
  classify  sort reads into graft/host/both/neither/ambiguous
            (``XenoApp.cc:137-254`` -> ``GossCmdGroupReads``)

Both run on the global ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..classify.annotated_set import (
    AnnotatedKmerSet,
    compute_near_kmers,
    merge_and_annotate,
)
from ..classify.xenome import (
    BATCH_READS,
    OUT_CLASS,
    classify_pair_batches,
    classify_read_batches,
    out_filename,
    print_stats,
    write_batch,
)
from ..cli.framework import App, Command, CommandError, Context, add_input_options, gather_read_files
from ..graph.build import build_kmer_set
from ..io.readers import read_batches, read_file, read_pair_batches
from ..utils import profile
from ..utils.logging import Timer


def _index_opts(p):
    p.add_argument("-K", "--kmer-size", type=int, default=25)
    p.add_argument("-G", "--graft", required=True,
                   help="graft reference in FASTA format")
    p.add_argument("-H", "--host", required=True,
                   help="host reference in FASTA format")
    p.add_argument("-P", "--prefix", required=True,
                   help="index filename prefix")
    p.add_argument("-M", "--max-memory", type=int, default=2,
                   help="maximum memory (GB) for counting buffers")
    p.add_argument("--chunk-size", type=int, default=1 << 20)


def _index_run(ctx: Context) -> None:
    k = int(ctx.opts.kmer_size)
    t = Timer()
    chunk = int(ctx.opts.chunk_size)
    # -M bounds the counting working set (~48B device footprint per
    # distinct key; the reference's buffer sizing, XenoApp.cc:103)
    cap = max((int(ctx.opts.max_memory) << 30) // 48, 1 << 20)
    ctx.log("info", "building graft kmer set")
    graft, _ = build_kmer_set(read_file(ctx.opts.graft, ctx.fac), k,
                              device=ctx.device, chunk=chunk, cap_entries=cap)
    ctx.log("info", f"graft: {graft.count} kmers")
    ctx.log("info", "building host kmer set")
    host, _ = build_kmer_set(read_file(ctx.opts.host, ctx.fac), k,
                             device=ctx.device, chunk=chunk, cap_entries=cap)
    ctx.log("info", f"host: {host.count} kmers")
    ann, common = merge_and_annotate(graft, host)
    ctx.log("info", f"union: {ann.kset.count} kmers ({common} common)")
    gray = compute_near_kmers(ann, ctx.device)
    ctx.log("info", f"marginal kmers: {gray}")
    ann.write(ctx.opts.prefix, ctx.fac)
    ctx.log("info", f"index built in {t.check():.1f}s")


def _classify_opts(p):
    p.add_argument("-P", "--prefix", required=True)
    add_input_options(p)
    p.add_argument("-M", "--max-memory", type=int, default=None,
                   help="memory budget in GB; larger indexes classify in "
                        "multiple passes over k-mer subranges")
    p.add_argument("--pairs", action="store_true",
                   help="treat inputs as pairs of read files")
    p.add_argument("--graft-name", default="graft")
    p.add_argument("--host-name", default="host")
    p.add_argument("--output-filename-prefix", default="")
    p.add_argument("--dont-write-reads", action="store_true")
    p.add_argument("--num-devices", type=int, default=0,
                   help="shard the index (k <= 30) over a mesh of N shards: "
                        "N cards for --device cuda, which raises when fewer "
                        "are visible, N shards on the CPU for --device cpu "
                        "(0 = auto: every visible card on cuda, one device "
                        "on cpu)")
    p.add_argument("--preserve-read-order", action="store_true",
                   help="accepted for reference compatibility: this "
                        "engine classifies in streaming batches, so "
                        "output order is ALWAYS the input order (the "
                        "reference only guarantees it with this flag in "
                        "multi-pass mode, GossCmdGroupReads.cc:579-686)")


def _classify_run(ctx: Context) -> None:
    import torch

    o = ctx.opts
    with profile.context("xenome/index_load"):
        ann = AnnotatedKmerSet.read(o.prefix, ctx.fac)
    n_devices = int(o.num_devices or 0)
    if n_devices == 0:
        n_devices = (torch.cuda.device_count() if ctx.device.type == "cuda"
                     else 1)
    passes = 1
    if o.max_memory:
        idx_bytes = ann.kset.lo.nbytes + ann.kset.hi.nbytes + 2 * ann.kset.count
        passes = max(1, -(-idx_bytes // (int(o.max_memory) << 30)))
        if passes > 1:
            ctx.log("info", f"classifying in {passes} passes")
    files = gather_read_files(ctx)
    suffix = "fastq" if any(f == "fastq" for _, f in files) else "fasta"
    counts = np.zeros(16, dtype=np.int64)
    write = not o.dont_write_reads

    kw = dict(device=ctx.device, passes=passes, n_devices=n_devices)
    if o.pairs:
        if len(files) % 2 != 0:
            raise CommandError("--pairs requires an even number of input files")
        halves = ("1", "2")
        batches = classify_pair_batches(read_pair_batches(
            [n for n, _ in files[0::2]], [n for n, _ in files[1::2]],
            BATCH_READS, ctx.fac), ann, **kw)
    else:
        halves = ("",)
        batches = (((batch,), blrg) for batch, blrg in classify_read_batches(
            read_batches(files, BATCH_READS, ctx.fac), ann, **kw))
    # each class's file, once a name (graft and host may name another class)
    names = {c: {"lhs": o.graft_name, "rhs": o.host_name}.get(c, c)
             for c in ("neither", "both", "ambiguous", "lhs", "rhs")}
    slots = list(dict.fromkeys(names.values()))
    slot_of = np.array([slots.index(names[c]) for c in OUT_CLASS], np.uint8)
    outs = {half: [] for half in halves} if write else {}  # a file a slot
    try:
        for c in slots if write else ():
            for half in halves:
                name = out_filename(o.output_filename_prefix, suffix, half, c)
                outs[half].append(ctx.fac.open_write(name))
                ctx.log("info", f"writing to {name}")
        for mates, blrg in batches:
            counts += np.bincount(blrg, minlength=16)
            if write:
                with profile.context("xenome/write"):
                    which = slot_of[blrg]
                    for half, batch in zip(halves, mates):
                        write_batch(outs[half], batch, which)
    finally:
        for f in (f for fs in outs.values() for f in fs):
            f.close()

    print_stats(sys.stdout, counts, o.graft_name, o.host_name, o.dont_write_reads)


def build_app() -> App:
    app = App("xenome", "xenome — xenograft read classifier (gossamer-tpu, "
                        "PyTorch port)")
    app.register(Command("index", "build an index for classifying reads",
                         _index_opts, _index_run))
    app.register(Command("classify", "classify reads according to index",
                         _classify_opts, _classify_run))
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
