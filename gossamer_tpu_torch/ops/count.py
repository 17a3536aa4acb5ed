"""K-mer counting entry points: route chunk streams into the engines.

Counterpart of ``gossamer_tpu/ops/count.py`` on one device.  Narrow keys
(2*rho <= 62) go through :class:`.engine.SpectrumEngine`: as packed chunks
when the chunk size is a multiple of 16 (the native reader yields them, and
the Python reader's flat code chunks are packed with
``io.stream.pack_chunk``), else as raw code chunks.  Wide keys (rho <= 63)
go through :class:`.engine_wide.SpectrumEngineWide` as raw code chunks from
either reader (the packed format stops at an overlap of 32 bases).
``n_devices > 1`` (or a ``mesh``) routes through the sharded engines of
:mod:`..parallel.count_sharded`, as ``gossamer_tpu/ops/count.py`` does.
"""

from __future__ import annotations

import json
import time
from typing import Iterable

import numpy as np
import torch

from ..io.readers import Read
from ..io.stream import flat_code_chunks, pack_chunk
from ..utils import profile
from .engine import SpectrumEngine, narrow_keys
from .engine_wide import SpectrumEngineWide, wide_keys

U64 = np.uint64


def _expand_symmetric(lo: np.ndarray, c: np.ndarray, rho: int):
    """Canonical classes -> symmetric edge spectrum (both orientations).

    Palindromic rho-mers (x == rc(x)) appear once with doubled count,
    matching the reference's fwd+rc insertion semantics
    (``src/ReverseComplementAdapter.hh``).
    """
    from ..core import kmer as K
    from ..io.native import NativeUnavailable, native_expand_symmetric

    try:
        out_lo, out_c = native_expand_symmetric(lo, c.astype(np.int64), rho)
        return out_lo, np.zeros_like(out_lo), out_c
    except NativeUnavailable:
        pass
    hi = np.zeros_like(lo)
    rlo, _rhi = K.reverse_complement(lo, hi, rho)
    pal = rlo == lo
    out_lo = np.concatenate([lo, rlo[~pal]])
    out_c = np.concatenate([np.where(pal, c * 2, c), c[~pal]])
    order = np.argsort(out_lo, kind="stable")
    out_lo = out_lo[order]
    out_c = out_c[order]
    return out_lo, np.zeros_like(out_lo), out_c


def _check_supported(rho: int) -> None:
    if not (narrow_keys(rho) or wide_keys(rho)):
        raise ValueError(f"rho-mers of {rho} bases do not fit 126 bits")


def _count_sharded(chunks, rho: int, *, mode: str, expand: bool, device,
                   chunk: int, cap_entries, progress, log, n_devices: int,
                   mesh):
    """The sharded route of :func:`count_chunks` (``gossamer_tpu/ops/
    count.py:134-180``): its chunk-size checks, the mesh of ``n_devices``
    shards unless ``mesh`` is given, the engine of the key width."""
    from ..parallel.count_sharded import (ShardedSpectrumEngine,
                                          ShardedSpectrumEngineWide)
    from ..parallel.mesh import data_mesh

    narrow = narrow_keys(rho)
    if not narrow and chunk <= 0:
        raise ValueError("--num-devices requires an explicit chunk size")
    if narrow and (chunk <= 0 or chunk % 16):
        raise ValueError("--num-devices requires an explicit chunk size "
                         "divisible by 16 (packed transfer format)")
    if mesh is None:
        mesh = data_mesh(n_devices, device)
    if narrow:
        eng = ShardedSpectrumEngine(mesh, rho, mode, chunk,
                                    cap=cap_entries or (1 << 23))
    else:
        eng = ShardedSpectrumEngineWide(mesh, rho, mode, chunk,
                                        cap=cap_entries or (1 << 22))
    if log is not None:
        log("info", f"count: {mesh}, per-shard cap {eng.cap_l}")
    n_chunks = 0
    t0 = time.perf_counter()
    for item in chunks:
        with profile.context("count/add_chunk"):
            if narrow:
                eng.add_chunk_packed(np.asarray(item[0]), np.asarray(item[1]))
            else:
                codes = np.asarray(item)
                want = chunk + rho - 1
                if len(codes) < want:  # pad the tail chunk
                    codes = np.concatenate(
                        [codes, np.full(want - len(codes), 255, np.uint8)])
                eng.add_chunk(codes)
        n_chunks += 1
        if progress is not None:
            progress(n_chunks * chunk)
    stream = time.perf_counter() - t0
    with profile.context("count/finish"):
        out = eng.finish_expanded() if expand else eng.finish()
    if log is not None:
        phases = {"stream": stream, **eng.phases}
        log("info", f"count: {n_chunks} chunks, {eng.spills} spills, "
                    f"phases (s) {json.dumps(phases)}")
    return out


def count_chunks(
    chunks,
    rho: int,
    *,
    both_strands: bool,
    canonical: bool,
    device: torch.device,
    chunk: int,
    cap_entries: int | None = None,
    progress=None,
    log=None,
    n_devices: int = 1,
    fold: bool = True,
    batch: int = 8,
    mesh=None,
    graph_counts: bool = False,
):
    """Count over chunks of ``chunk`` windows -> sorted (lo, hi, counts)
    host arrays.  A chunk is a ``(words, inval)`` packed tuple (narrow keys,
    ``chunk`` a multiple of 16) or a uint8 array of ``chunk + rho - 1`` raw
    codes; ``chunk=0`` takes the windows of a raw chunk from the first one.

    ``both_strands`` counts every window and its reverse complement
    (build-graph semantics): canonical classes are counted at half the
    lane volume and expanded to both orientations at the end.
    ``canonical`` counts each window's class under the reference's FNV
    order (build-kmer-set semantics, ``src/GossCmdBuildKmerSet.tcc:248-249``).
    ``fold``
    selects the merge-fold kernel or its plain version (narrow engine
    argument; the wide engine has no kernel).  ``batch`` chunks make one
    flush.  ``n_devices > 1`` counts on a mesh of that many shards
    (:func:`..parallel.mesh.data_mesh` on ``device``), as does a ``mesh``
    given; ``batch`` and ``fold`` then do not apply.
    ``graph_counts`` (build-graph's write) adds a fourth item: the
    counts' histogram ``(mult, freq)`` where the one-device expansion made
    it on the device, its counts then those the graph file holds (the
    engines' ``finish_expanded(graph_counts=True)`` and ``hist``); else
    None.
    """
    _check_supported(rho)
    mode = "ref" if canonical else ("value" if both_strands else "plain")
    chunks = profile.iterate("count/read", chunks)  # the reader's next()
    if n_devices > 1 or mesh is not None:
        out = _count_sharded(chunks, rho, mode=mode, expand=both_strands,
                             device=device,
                             chunk=chunk, cap_entries=cap_entries,
                             progress=progress, log=log,
                             n_devices=n_devices, mesh=mesh)
        return (*out, None) if graph_counts else out
    narrow = narrow_keys(rho)
    if chunk < 0:
        raise ValueError(f"negative chunk size {chunk}")
    on_spill = None
    if log is not None:
        on_spill = lambda i, n: log(  # noqa: E731
            "info", f"spill {i}: {n:,} distinct keys -> host RAM run")
    eng = None
    n_chunks = 0
    t0 = time.perf_counter()
    for item in chunks:
        packed = isinstance(item, tuple)
        if eng is None:
            if packed and (chunk <= 0 or chunk % 16):
                raise ValueError(f"packed chunks need a chunk size divisible "
                                 f"by 16 (got {chunk})")
            lanes = chunk or len(item) - rho + 1
            if narrow:
                cap = cap_entries or min(1 << 25, max(1 << 16, 4 * lanes))
                eng = SpectrumEngine(rho, mode, lanes, device, batch=batch,
                                     cap=cap, on_spill=on_spill, fold=fold)
            else:
                cap = cap_entries or min(1 << 24, max(1 << 16, 4 * lanes))
                eng = SpectrumEngineWide(rho, mode, lanes, device, batch=batch,
                                         cap=cap, on_spill=on_spill)
        with profile.context("count/add_chunk"):
            if packed:
                eng.add_chunk_packed(np.asarray(item[0]), np.asarray(item[1]))
            else:
                eng.add_chunk(np.asarray(item))
        n_chunks += 1
        if progress is not None:
            progress(n_chunks * lanes)
    if eng is None:
        z = np.zeros(0, dtype=U64)
        out = z, z.copy(), np.zeros(0, dtype=np.int64)
        return (*out, None) if graph_counts else out
    stream = time.perf_counter() - t0
    with profile.context("count/finish"):
        out = eng.finish_expanded(graph_counts) if both_strands else eng.finish()
    if log is not None:
        phases = {"stream": stream, **eng.phases}
        finish = "; ".join(getattr(eng, "finish_log", ()))
        pulls = "; ".join(getattr(eng, "pulls", ()))
        log("info", f"count: {n_chunks} chunks, {eng.spills} spills, "
                    + (f"pulls: {pulls}, " if pulls else "")
                    + (f"finish: {finish}, " if finish else "")
                    + f"phases (s) {json.dumps(phases)}")
    return (*out, eng.hist) if graph_counts else out


def count_rho_mers(reads: Iterable[Read], rho: int, *, chunk: int = 1 << 22,
                   **kw):
    """Count rho-mers of a read stream (Python reader; narrow chunks packed
    with ``pack_chunk`` when ``chunk`` is a multiple of 16) -> sorted (lo,
    hi, counts) host arrays."""
    if chunk <= 0:
        raise ValueError(f"need a positive chunk size (got {chunk})")
    chunks = flat_code_chunks(reads, rho, chunk=chunk)
    if narrow_keys(rho) and chunk % 16 == 0:
        chunks = (pack_chunk(codes, rho, chunk) for codes in chunks)
    return count_chunks(chunks, rho, chunk=chunk, **kw)


def count_rho_mers_files(paths: list[str], rho: int, *, chunk: int = 1 << 22,
                         fmt: str | None = None, threads: int = 1, log=None,
                         **kw):
    """Count straight from files through the native reader (packed chunks
    for narrow keys at a chunk size divisible by 16, else raw codes); only
    when the native library is unavailable, through the Python parser
    chain."""
    from ..io.native import (NativeUnavailable, native_flat_chunks,
                             native_packed_chunks)
    from ..io.readers import read_files

    _check_supported(rho)
    packed = narrow_keys(rho) and chunk % 16 == 0
    reader = native_packed_chunks if packed else native_flat_chunks
    try:
        chunks = reader(paths, rho, chunk=chunk, fmt=fmt, threads=threads)
    except NativeUnavailable as e:
        if log is not None:
            log("warning", f"reader: python (native library unavailable: {e})")
        return count_rho_mers(read_files(paths), rho, chunk=chunk, log=log,
                              **kw)
    if log is not None:
        log("info", "reader: native")
    return count_chunks(chunks, rho, chunk=chunk, log=log, **kw)
