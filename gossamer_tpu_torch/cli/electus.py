"""``electus`` of the port: generalized read filter/classifier (reference
``src/ElectApp.cc``; ``gossamer_tpu/cli/electus.py``).

    python -m gossamer_tpu_torch.cli.electus index -K 25 -I a.fa -I b.fa -P refs
    python -m gossamer_tpu_torch.cli.electus classify -P refs -i reads.fastq

Commands:
  index     one k-mer set per reference file (or per sequence), counted on
            the device like ``goss build-kmer-set``
  classify  split reads into matched / nonmatched by the number of
            references their k-mers hit

Both run on the global ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import json

from ..classify.electus import RefMaskSet, filter_pairs, filter_reads
from ..classify.xenome import print_read
from ..cli.framework import (
    App,
    Command,
    CommandError,
    Context,
    add_input_options,
    gather_read_files,
)
from ..graph.build import build_kmer_set
from ..graph.kmer_set import KmerSet
from ..io.readers import Read, parse_fasta, read_file, read_pair_files


# Distinct-key cap of the device spectrum while a reference is counted: the
# default of ``goss build-kmer-set`` (``-B 2``).  The JAX CLI leaves the
# engine's default, four chunks, which one flush of eight chunks of a
# reference without repeats exceeds ("distinct keys of one batch exceeded
# cap"); the sets written are the same under any cap.
INDEX_CAP = (2 << 30) // 48


def _index_opts(p):
    p.add_argument("-K", "--kmer-size", type=int, default=25)
    p.add_argument("-P", "--prefix", required=True,
                   help="reference output prefix")
    p.add_argument("--single-sequence-refs", action="store_true",
                   help="treat each sequence as a separate reference")
    add_input_options(p)
    p.add_argument("--chunk-size", type=int, default=1 << 18)


def _index_run(ctx: Context) -> None:
    k = int(ctx.opts.kmer_size)
    files = gather_read_files(ctx)
    refs: list[str] = []
    chunk = int(ctx.opts.chunk_size)
    if ctx.opts.single_sequence_refs:
        seqs = []
        for name, fmt in files:
            for rd in read_file(name, ctx.fac, fmt):
                seqs.append(rd)
        for i, rd in enumerate(seqs):
            ks, _ = build_kmer_set([rd], k, device=ctx.device, chunk=chunk,
                                   cap_entries=INDEX_CAP)
            name = f"{ctx.opts.prefix}.{i}"
            ks.write(name, ctx.fac)
            refs.append(name)
    else:
        for i, (name, fmt) in enumerate(files):
            ks, _ = build_kmer_set(read_file(name, ctx.fac, fmt), k,
                                   device=ctx.device, chunk=chunk,
                                   cap_entries=INDEX_CAP)
            out = f"{ctx.opts.prefix}.{i}"
            ks.write(out, ctx.fac)
            refs.append(out)
    ctx.fac.write_text(ctx.opts.prefix + ".refs",
                       json.dumps({"K": k, "refs": refs}))
    ctx.log("info", f"electus index: {len(refs)} reference sets")


def _classify_opts(p):
    p.add_argument("-P", "--prefix", default=None,
                   help="reference index prefix (from electus index)")
    p.add_argument("--ref-index", action="append", default=[],
                   help="prefix of an individual reference k-mer set")
    add_input_options(p)
    p.add_argument("--pairs", action="store_true")
    p.add_argument("--ref-threshold", type=int, default=1,
                   help="number of distinct references required to match")
    p.add_argument("--match-prefix", default="matched")
    p.add_argument("--non-match-prefix", default="nonmatched")
    p.add_argument("--dont-write-reads", action="store_true")
    p.add_argument("--preserve-read-order", action="store_true")


def _classify_run(ctx: Context) -> None:
    o = ctx.opts
    ref_names: list[str] = list(o.ref_index)
    if o.prefix:
        meta = json.loads(ctx.fac.read_text(o.prefix + ".refs"))
        ref_names = meta["refs"] + ref_names
    if not ref_names:
        raise CommandError("no reference sets (-P or --ref-index)")
    sets = [KmerSet.read(n, ctx.fac) for n in ref_names]
    refs = RefMaskSet.build(sets)
    files = gather_read_files(ctx)
    suffix = "fastq" if any(f == "fastq" for _, f in files) else "fasta"
    write = not o.dont_write_reads

    n_match = 0
    n_total = 0
    if o.pairs:
        lhs_files = [n for n, _ in files[0::2]]
        rhs_files = [n for n, _ in files[1::2]]
        outs = {}
        if write:
            for key, pfx in (("m", o.match_prefix), ("n", o.non_match_prefix)):
                for half in ("1", "2"):
                    outs[(key, half)] = ctx.fac.open_write_text(
                        f"{pfx}_{half}.{suffix}")
        try:
            for a, b, m in filter_pairs(
                read_pair_files(lhs_files, rhs_files, ctx.fac), refs,
                int(o.ref_threshold), device=ctx.device,
            ):
                n_total += 1
                n_match += int(m)
                if write:
                    key = "m" if m else "n"
                    print_read(outs[(key, "1")], a)
                    print_read(outs[(key, "2")], b)
        finally:
            for f in outs.values():
                f.close()
    else:
        outs = {}
        if write:
            outs["m"] = ctx.fac.open_write_text(f"{o.match_prefix}.{suffix}")
            outs["n"] = ctx.fac.open_write_text(f"{o.non_match_prefix}.{suffix}")
        try:
            for rd, m in filter_reads(
                (r for name, fmt in files for r in read_file(name, ctx.fac, fmt)),
                refs, int(o.ref_threshold), device=ctx.device,
            ):
                n_total += 1
                n_match += int(m)
                if write:
                    print_read(outs["m" if m else "n"], rd)
        finally:
            for f in outs.values():
                f.close()
    print(f"{n_match}\t{n_total - n_match}\t{n_total}")


def build_app() -> App:
    app = App("electus", "electus — read filter against reference k-mer sets "
                         "(gossamer-tpu, PyTorch port)")
    app.register(Command("index", "build reference k-mer sets", _index_opts, _index_run))
    app.register(Command("classify", "filter reads against references",
                         _classify_opts, _classify_run))
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
