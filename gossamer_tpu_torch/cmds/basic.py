"""goss commands: build/dump/restore/lint for graphs and k-mer sets
(``gossamer_tpu/cmds/basic.py``, ``src/GossApp.cc:101-143``).

Option names and flags follow the reference registration and the JAX
package's mesh and coordinator options (``--num-devices``,
``--coordinator``, ``--num-processes``, ``--process-id``).
"""

from __future__ import annotations

import numpy as np

from .. import MAX_K
from ..cli.framework import Command, CommandError, Context, add_input_options, gather_read_files
from ..utils import profile
from ..utils.logging import Timer


# Device bytes of one flush of the wide count (keys of k > 30), read off
# ``python3 chip_smoke.py --wide-memory`` on an H100 at rho 56 (PERF.md):
# a flush of n windows into a resident spectrum of S lanes peaks at no
# more than WIDE_KEY_BYTES * S + WIDE_WINDOW_BYTES * n (24 B of resident
# lanes and up to 114 B of merge and stable-sort workspace a key; up to
# 146 B of k-merize and merge a window, and the window's code).  The
# finish's expansion on the card takes its own peak, about 243 B a live
# key beside the 24 B a lane of the resident spectrum (an H100 at rho 56,
# -B 16: 10.1 GB for 35.0M live keys in 67.1M lanes): inside -B while the
# live keys stay below (-B - 24 B x cap) / 243 B.
WIDE_KEY_BYTES = 138
WIDE_WINDOW_BYTES = 147
FLUSH_CHUNKS = (8, 4, 2, 1)


def _chunk_opts(p):
    p.add_argument("-B", "--buffer-size", type=int, default=2,
                   help="maximum size (in GB) of the count's device memory; "
                        "spectra outgrowing it spill to host RAM (the "
                        "reference's RAM->disk spill, docs/goss.md:327-338). "
                        "k <= 30: it caps the resident spectrum at 48 B a key, "
                        "as the JAX CLI does. k > 30: it holds the resident "
                        "spectrum and one flush together (138 B a key, 147 B a "
                        "window of the flush): a flush takes 8, 4, 2 or 1 "
                        "chunks, the most that leave room for twice their "
                        "windows; where one chunk's flush does not fit, the "
                        "spectrum gets twice a chunk's windows and the peak "
                        "passes -B. The finish expands the live keys on the "
                        "card at about 243 B a key beside the resident "
                        "spectrum, inside -B while they stay below about half "
                        "the cap. With --num-devices above 1 the cap is "
                        "the 48 B a key one for every k, split evenly over "
                        "the shards, which never spill")
    p.add_argument("--chunk-size", type=int, default=1 << 22,
                   help="device batch size in k-mer windows (a multiple "
                        "of 16)")
    p.add_argument("--spectrum-cap", type=int, default=0,
                   help="override the device-resident distinct-key cap")
    p.add_argument("--num-devices", type=int, default=0,
                   help="count on a mesh of N shards (hash-partitioned key "
                        "space, one all-to-all a flush): N cards for --device "
                        "cuda, which raises when fewer are visible, N shards "
                        "on the CPU for --device cpu; 0 = auto: every visible "
                        "card when there are several, a power of two, k <= 30 "
                        "and a chunk size divisible by 16, else one device")
    p.add_argument("--coordinator", default=None,
                   help="counting over several processes (one per host): "
                        "host:port of process 0 for torch.distributed "
                        "(nccl for --device cuda, gloo for cpu); each "
                        "process reads its round-robin share of the input "
                        "files (the reference's analog is per-machine builds "
                        "+ merge-graphs, docs/goss.md:52-55)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)


def wide_sizing(buffer_gb: int, chunk: int) -> tuple[int, int, bool]:
    """-B for wide keys -> (cap in keys, chunks a flush, whether the flush
    fits): the most chunks a flush whose cap can still hold twice its
    windows within ``buffer_gb`` GiB of device memory."""
    budget = int(buffer_gb) << 30
    for batch in FLUSH_CHUNKS:
        n = batch * chunk
        cap = (budget - WIDE_WINDOW_BYTES * n) // WIDE_KEY_BYTES
        if cap >= 2 * n:
            return cap, batch, True
    return 2 * chunk, 1, False


def _resolve_num_devices(ctx: Context, rho: int) -> int:
    """--num-devices: an explicit N is honored (what it cannot run raises
    later); 0 = auto, which takes every visible card only when there are
    several and the sharded engine supports the configuration
    (``gossamer_tpu/cmds/basic.py:52-68``).  On the CPU auto is 1."""
    import torch

    from ..ops.engine import narrow_keys

    n = int(getattr(ctx.opts, "num_devices", 0) or 0)
    if n == 0:
        if ctx.device.type != "cuda":
            return 1
        n = torch.cuda.device_count()
        chunk = int(ctx.opts.chunk_size)
        if (n & (n - 1)) or not narrow_keys(rho) or rho > 33 or chunk % 16:
            n = 1
    return max(1, n)


def _chunk_kwargs(ctx: Context, rho: int) -> dict:
    from ..ops.engine import narrow_keys

    override = int(getattr(ctx.opts, "spectrum_cap", 0) or 0)
    chunk = int(ctx.opts.chunk_size)
    n_devices = _resolve_num_devices(ctx, rho)
    if narrow_keys(rho) or n_devices > 1:
        # ~48 B device footprint per distinct key (3 u32 planes + sort
        # workspace in the JAX engine); the same default keeps the two
        # CLIs' caps equal, and so the per-shard caps of the sharded count
        cap = override or max((int(ctx.opts.buffer_size) << 30) // 48, 1 << 20)
        batch = FLUSH_CHUNKS[0]
    else:
        cap, batch, fits = wide_sizing(ctx.opts.buffer_size, chunk)
        if not fits:
            need = (WIDE_KEY_BYTES * cap + WIDE_WINDOW_BYTES * chunk) / 2**30
            ctx.log("warning", f"-B {ctx.opts.buffer_size}: one flush of "
                               f"{chunk} windows needs about {need:.2f} GiB of "
                               f"device memory; -B does not bound it")
        cap = override or cap
    return {"chunk": chunk, "cap_entries": cap, "batch": batch,
            "device": ctx.device, "n_devices": n_devices}


# ---------------------------------------------------------------- build-graph
def _build_graph_opts(p):
    p.add_argument("-k", "--kmer-size", type=int, required=True)
    p.add_argument("-O", "--graph-out", required=True)
    add_input_options(p)
    _chunk_opts(p)


def _counted_spectrum(ctx: Context, rho: int, *, both, canon,
                      graph_counts=False):
    """Count the input files: physical files straight from disk (the
    native reader when available), any other file factory through its
    own reads.  ``graph_counts``: the counts as the graph file holds them
    and their histogram besides (``ops.count.count_chunks``)."""
    from ..cli.framework import iter_reads
    from ..io.factory import PhysicalFileFactory
    from ..ops.count import count_rho_mers, count_rho_mers_files
    from ..utils.logging import UnboundedProgressMonitor

    files = gather_read_files(ctx)
    if getattr(ctx.opts, "coordinator", None):
        from ..parallel import distributed

        files, n_global = distributed.configure(ctx.opts, files, ctx.device,
                                                log=ctx.log)
        if n_global and not getattr(ctx.opts, "num_devices", 0):
            ctx.opts.num_devices = n_global
    kw = _chunk_kwargs(ctx, rho)
    mon = UnboundedProgressMonitor(ctx.log, interval=1 << 26, unit="bases",
                                   label="counting")
    kw.update(progress=mon.tick, log=ctx.log, graph_counts=graph_counts)
    if isinstance(ctx.fac, PhysicalFileFactory):
        return count_rho_mers_files(
            [n for n, _ in files], rho, both_strands=both, canonical=canon,
            threads=int(getattr(ctx.opts, "num_threads", 1) or 1), **kw)
    return count_rho_mers(iter_reads(ctx, files), rho, both_strands=both,
                          canonical=canon, **kw)


def _build_graph_run(ctx: Context) -> None:
    from ..graph.graph import Graph

    k = int(ctx.opts.kmer_size)
    if k > MAX_K:
        raise CommandError(f"kmer size {k} exceeds maximum {MAX_K}")
    t = Timer()
    lo, hi, counts, hist = _counted_spectrum(ctx, k + 1, both=True,
                                             canon=False, graph_counts=True)
    with profile.context("build-graph/graph"):
        g = Graph(k, lo, hi, counts, asymmetric=False)
    g.write(ctx.opts.graph_out, ctx.fac, hist)
    ctx.log("info", f"build-graph: {g.count} edges in {t.check():.2f}s")
    if ctx.debug("dump-graph-build-stats") or ctx.debug("print-stats"):
        import json

        ctx.log("info", "stats: " + json.dumps(g.stat()))
    if ctx.debug("lint-after-build"):
        errs = g.lint()
        if errs:
            raise CommandError("lint failed: " + "; ".join(errs))


# ------------------------------------------------------------- build-kmer-set
def _build_kmer_set_run(ctx: Context) -> None:
    from ..graph.kmer_set import KmerSet

    k = int(ctx.opts.kmer_size)
    if k > MAX_K:
        raise CommandError(f"kmer size {k} exceeds maximum {MAX_K}")
    t = Timer()
    lo, hi, _counts = _counted_spectrum(ctx, k, both=False, canon=True)
    ks = KmerSet(k, lo, hi)
    ks.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"build-kmer-set: {ks.count} kmers in {t.check():.2f}s")


# ----------------------------------------------------------------- dump/restore
def _graph_in_out_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")


def _dump_graph_run(ctx: Context) -> None:
    from ..graph.graph import Graph
    from ..graph.text import dump_graph

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        dump_graph(g, out)


def _dump_kmer_set_run(ctx: Context) -> None:
    from ..graph.kmer_set import KmerSet

    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        ks.dump_text(out)


def _restore_graph_opts(p):
    p.add_argument("-f", "--input-file", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _restore_graph_run(ctx: Context) -> None:
    from ..graph.text import restore_graph

    with ctx.fac.open_read_text(ctx.opts.input_file) as inp:
        g = restore_graph(inp)
    g.write(ctx.opts.graph_out, ctx.fac)


# -------------------------------------------------------------------- lint
def _lint_graph_opts(p):
    p.add_argument("-G", "--graph-in", required=True)


def _lint_graph_run(ctx: Context) -> None:
    from ..graph.graph import Graph

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    errs = g.lint()
    for e in errs:
        ctx.log("error", f"lint-graph: {e}")
    if errs:
        raise CommandError(f"lint-graph: {len(errs)} invariant(s) violated")
    ctx.log("info", "lint-graph: ok")


# ------------------------------------------------------------- graph-to-kmer-set
def _graph_to_kmer_set_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _graph_to_kmer_set_run(ctx: Context) -> None:
    """Project a graph's edge set to the canonical k-mer set of its
    (k+1)-mers (``src/GossCmdGraphToKmerSet.cc``)."""
    from ..core import kmer as KK
    from ..graph.graph import Graph
    from ..graph.kmer_set import KmerSet

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    lo, hi, _ = KK.normalize(g.lo, g.hi, g.rho)
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    if len(lo):
        keep = np.ones(len(lo), dtype=bool)
        keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi = lo[keep], hi[keep]
    KmerSet(g.rho, lo, hi).write(ctx.opts.graph_out, ctx.fac)


COMMANDS = [
    Command("build-graph", "create a new graph", _build_graph_opts, _build_graph_run),
    Command("build-kmer-set", "create a set of canonical k-mers",
            _build_graph_opts, _build_kmer_set_run),
    Command("dump-graph", "dump a graph as text", _graph_in_out_opts, _dump_graph_run),
    Command("dump-kmer-set", "dump a k-mer set as text",
            _graph_in_out_opts, _dump_kmer_set_run),
    Command("restore-graph", "restore a graph from text",
            _restore_graph_opts, _restore_graph_run),
    Command("lint-graph", "check graph invariants", _lint_graph_opts, _lint_graph_run),
    Command("graph-to-kmer-set", "project a graph to a k-mer set",
            _graph_to_kmer_set_opts, _graph_to_kmer_set_run),
]
