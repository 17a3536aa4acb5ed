"""``espresso`` — k-mer spectra as MATLAB matrices (``src/EspressoApp.cc``,
``src/KmerSpectrum.{hh,cc}``; ``gossamer_tpu/cli/espresso.py``).

    python -m gossamer_tpu_torch.cli.espresso single -k 10 -I r.fa -o s.mat

Commands: single / multi (dense 4^k count rows), sparse-single /
sparse-multi (rows over a reference KmerSet), query, similarity.
Matrices are written as MATLAB ``.mat`` via scipy.io (the reference links
matio; disabled in its build, ``src/CMakeLists.txt:176-186``).  Host
code; read windows take their read ids from the read starts
(:func:`..cmds.more._windows`).
"""

from __future__ import annotations

import numpy as np

from ..cli.framework import (
    App,
    Command,
    CommandError,
    Context,
    add_input_options,
    gather_read_files,
)
from ..core import kmer as K
from ..graph.kmer_set import KmerSet
from ..io.readers import read_file


def _count_vector(ctx: Context, files, k: int) -> np.ndarray:
    """Dense canonical k-mer count vector of length 4^k."""
    if k > 12:
        raise CommandError("dense spectra need k <= 12 (use sparse-* above)")
    vec = np.zeros(4 ** k, dtype=np.int64)
    from ..cmds.more import _read_batches, _windows

    for name, fmt in files:
        for buf in _read_batches(read_file(name, ctx.fac, fmt)):
            codes = [K.encode_bases(r.seq) for r in buf]
            lo, hi, valid, _rid, _ = _windows(codes, k)
            nlo, _nhi, _ = K.normalize(lo[valid], hi[valid], k)
            np.add.at(vec, nlo.astype(np.int64), 1)
    return vec


def _sparse_counts(ctx: Context, files, ks: KmerSet) -> np.ndarray:
    vec = np.zeros(ks.count, dtype=np.int64)
    from ..cmds.more import _read_batches, _windows

    for name, fmt in files:
        for buf in _read_batches(read_file(name, ctx.fac, fmt)):
            codes = [K.encode_bases(r.seq) for r in buf]
            lo, hi, valid, _rid, _ = _windows(codes, ks.k)
            nlo, nhi, _ = K.normalize(lo[valid], hi[valid], ks.k)
            hit, r = ks.access_and_rank(nlo, nhi)
            np.add.at(vec, r[hit], 1)
    return vec


def _savemat(name: str, data: dict) -> None:
    from scipy.io import savemat

    savemat(name, data)


def _single_opts(p):
    p.add_argument("-k", "--kmer-size", type=int, default=10)
    p.add_argument("-S", "--sample", default="sample")
    p.add_argument("-o", "--output-file", required=True)
    add_input_options(p)


def _single_run(ctx: Context) -> None:
    files = gather_read_files(ctx)
    vec = _count_vector(ctx, files, int(ctx.opts.kmer_size))
    _savemat(ctx.opts.output_file, {ctx.opts.sample: vec[None, :]})
    ctx.log("info", f"espresso single: {int(vec.sum())} kmers")


def _multi_run(ctx: Context) -> None:
    files = gather_read_files(ctx)
    rows = [_count_vector(ctx, [f], int(ctx.opts.kmer_size)) for f in files]
    _savemat(ctx.opts.output_file, {ctx.opts.sample: np.stack(rows)})
    ctx.log("info", f"espresso multi: {len(rows)} samples")


def _sparse_opts(p):
    p.add_argument("-G", "--graph-in", required=True,
                   help="reference k-mer set defining the columns")
    p.add_argument("-S", "--sample", default="sample")
    p.add_argument("-o", "--output-file", required=True)
    add_input_options(p)


def _sparse_single_run(ctx: Context) -> None:
    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)
    vec = _sparse_counts(ctx, files, ks)
    _savemat(ctx.opts.output_file, {ctx.opts.sample: vec[None, :]})


def _sparse_multi_run(ctx: Context) -> None:
    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)
    rows = [_sparse_counts(ctx, [f], ks) for f in files]
    _savemat(ctx.opts.output_file, {ctx.opts.sample: np.stack(rows)})


def _query_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    add_input_options(p)


def _query_run(ctx: Context) -> None:
    """Per-read counts of reference k-mers hit (``EspressoApp.cc`` query)."""
    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    files = gather_read_files(ctx)
    from ..cmds.more import _read_batches, _windows

    for name, fmt in files:
        for buf in _read_batches(read_file(name, ctx.fac, fmt)):
            codes = [K.encode_bases(r.seq) for r in buf]
            lo, hi, valid, rid, _ = _windows(codes, ks.k)
            nlo, nhi, _ = K.normalize(lo, hi, ks.k)
            hit, _r = ks.access_and_rank(nlo, nhi)
            hit &= valid
            per_read = np.zeros(len(buf), dtype=np.int64)
            np.add.at(per_read, rid[hit], 1)
            for rd, c in zip(buf, per_read):
                print(f"{rd.label}\t{int(c)}")


def _similarity_opts(p):
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("--matrices", action="append", required=True,
                   help=".mat files from single/multi runs")


def _similarity_run(ctx: Context) -> None:
    """Pairwise cosine similarity between spectrum rows."""
    from scipy.io import loadmat

    rows = []
    names = []
    for m in ctx.opts.matrices:
        data = loadmat(m)
        for key, val in data.items():
            if key.startswith("__"):
                continue
            for i, row in enumerate(np.atleast_2d(val)):
                rows.append(row.astype(np.float64))
                names.append(f"{m}:{key}:{i}")
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        for i in range(len(rows)):
            for j in range(i + 1, len(rows)):
                a, b = rows[i], rows[j]
                denom = np.linalg.norm(a) * np.linalg.norm(b)
                sim = float(a @ b / denom) if denom else 0.0
                out.write(f"{names[i]}\t{names[j]}\t{sim:.6g}\n")


def build_app() -> App:
    app = App("espresso", "espresso — k-mer spectra matrices (gossamer-tpu, PyTorch port)")
    app.register(Command("single", "dense spectrum, one sample",
                         _single_opts, _single_run))
    app.register(Command("multi", "dense spectra, one sample per input file",
                         _single_opts, _multi_run))
    app.register(Command("sparse-single", "sparse spectrum over a k-mer set",
                         _sparse_opts, _sparse_single_run))
    app.register(Command("sparse-multi", "sparse spectra per input file",
                         _sparse_opts, _sparse_multi_run))
    app.register(Command("query", "count reference k-mers per read",
                         _query_opts, _query_run))
    app.register(Command("similarity", "pairwise spectrum similarity",
                         _similarity_opts, _similarity_run))
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
