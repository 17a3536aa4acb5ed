"""Merge of two sorted key runs: the Hopper kernel and its plain version.

Counterpart of ``gossamer_tpu/ops/pallas_merge.py`` ``merge_sorted_planes``.
:func:`merge_sorted` merges two ascending int64 runs of (key, value) lanes
into one ascending run of nA + nB lanes; values travel with their keys and
nothing is deduplicated.  On equal keys A's lanes come first, so the result
is a stable sort of A ++ B.

* CUDA tensors launch ``csrc/merge.cu``, which replaces the Pallas kernel
  ``pallas_merge._merge_kernel``, in two kernels: ``merge_splits`` (the
  merge-path split of every tile boundary, :func:`merge_splits`) and
  ``merge_tiles`` (persistent blocks that merge the tiles from those
  splits, the next tiles' copies in flight while one merges).  It is bound
  by device-memory bytes: one pass reading and writing (nA + nB) x 16 B
  (see the source).
* CPU tensors take :func:`merge_sorted_reference`, the plain PyTorch
  version: a stable sort of the concatenation; and :func:`merge_splits`
  takes :func:`merge_splits_reference`, a binary search over all tile
  boundaries at once.

Device classify (:mod:`..classify.device`) joins each batch of sorted
queries to the sorted index with it.  The kernel library is built with
``nvcc`` into ``gossamer_tpu_torch/_build`` at first use (:mod:`.nvcc`)
and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .nvcc import build_library

PROFILE_WORDS = 8  # clock-cycle sums of a -DMERGE_PROFILE build (csrc/merge.cu)


@functools.cache
def _kernel_lib(**defines: int) -> ctypes.CDLL:
    """The kernel library; ``defines`` (``MERGE_THREADS``, ``MERGE_ITEMS``,
    ``MERGE_STAGES``, ``MERGE_SPLIT_GROUP``, ``MERGE_PROFILE``) build and
    load a variant, for tuning."""
    so, _, _ = build_library("merge", defines)
    lib = ctypes.CDLL(str(so))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gossamer_merge_splits.restype = i
    lib.gossamer_merge_splits.argtypes = [i, vp, ll, vp, ll, ll, vp, vp]
    lib.gossamer_merge_sorted.restype = i
    lib.gossamer_merge_sorted.argtypes = [i, vp, vp, ll, vp, vp, ll, vp, vp,
                                          vp, vp]
    for name in ("gossamer_merge_tile", "gossamer_merge_threads",
                 "gossamer_merge_stages", "gossamer_merge_smem_bytes",
                 "gossamer_merge_split_group"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    lib.gossamer_merge_blocks_per_sm.restype = i
    lib.gossamer_merge_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
    lib.gossamer_merge_profile.restype = i
    lib.gossamer_merge_profile.argtypes = [i, vp, i]
    lib.gossamer_merge_error_string.restype = ctypes.c_char_p
    lib.gossamer_merge_error_string.argtypes = [i]
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gossamer_merge_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def blocks_per_sm(lib=None, device=None) -> int:
    """Blocks of ``merge_tiles`` (of ``lib``, else the default build) that
    one SM of ``device`` holds at a time, as the launch sizes its grid."""
    lib = lib or _kernel_lib()
    blocks = ctypes.c_int(0)
    dev = torch.device(device if device is not None else "cuda")
    _raise_on(lib, lib.gossamer_merge_blocks_per_sm(_device_index(dev),
                                                    ctypes.byref(blocks)),
              "merge_tiles occupancy query")
    return blocks.value


def _check_run(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"merge: {name} on {t.device}, a_keys on {dev}")
    if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"merge: {name} must be a contiguous 1-D int64 "
                         f"tensor (got {t.dtype}, shape {tuple(t.shape)})")


def _check(a_keys, a_vals, b_keys, b_vals) -> None:
    dev = a_keys.device
    for name, t in (("a_keys", a_keys), ("a_vals", a_vals),
                    ("b_keys", b_keys), ("b_vals", b_vals)):
        _check_run(name, t, dev)
    if a_vals.numel() != a_keys.numel() or b_vals.numel() != b_keys.numel():
        raise ValueError("merge_sorted: keys and values differ in length")


def n_tiles(n: int, tile: int) -> int:
    """Tiles of ``tile`` merged lanes over ``n`` lanes (the last may be
    short)."""
    return -(-n // tile)


def merge_sorted(a_keys: torch.Tensor, a_vals: torch.Tensor,
                 b_keys: torch.Tensor, b_vals: torch.Tensor):
    """Merge the ascending runs A and B -> ``(keys, vals)`` of nA + nB lanes.

    Keys are int64 (the engine's sentinel 2^63 - 1 sorts last like any
    other key); values are int64 payloads, e.g. counts or ids.  A and B
    must each be ascending: the kernel does not check, and for runs that
    are not the result is unspecified (it still stays in its buffers).
    """
    _check(a_keys, a_vals, b_keys, b_vals)
    dev = a_keys.device
    if dev.type == "cpu":
        return merge_sorted_reference(a_keys, a_vals, b_keys, b_vals)
    if dev.type == "cuda":
        return _launch(a_keys, a_vals, b_keys, b_vals)
    raise ValueError(f"merge_sorted: no kernel for device {dev}")


merge_sorted.launches = 0  # kernel launches, read by chip_smoke.py


def merge_splits(a_keys: torch.Tensor, b_keys: torch.Tensor, tile: int,
                 lib=None) -> torch.Tensor:
    """The merge-path split of every tile boundary of A and B merged:
    int64 ``splits[t]``, the A lanes among the first ``min(t * tile, nA +
    nB)`` merged lanes (A first on equal keys), ``t = 0 .. n_tiles(nA +
    nB, tile)``.  Tile t of the merge is then ``a[splits[t]:splits[t+1]]``
    merged with B's lanes between the same diagonals.  ``lib`` is a kernel
    build of :func:`_kernel_lib` (tests and tuning pass variants)."""
    dev = a_keys.device
    _check_run("a_keys", a_keys, dev)
    _check_run("b_keys", b_keys, dev)
    tile = int(tile)
    if tile < 1:
        raise ValueError(f"merge_splits: tile must be >= 1 (got {tile})")
    if dev.type == "cpu":
        return merge_splits_reference(a_keys, b_keys, tile)
    if dev.type != "cuda":
        raise ValueError(f"merge_splits: no kernel for device {dev}")
    lib = lib or _kernel_lib()
    out = torch.empty(n_tiles(a_keys.numel() + b_keys.numel(), tile) + 1,
                      dtype=torch.int64, device=dev)
    err = lib.gossamer_merge_splits(
        _device_index(dev), a_keys.data_ptr(), a_keys.numel(),
        b_keys.data_ptr(), b_keys.numel(), tile, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "merge_splits kernel launch")
    merge_splits.launches += 1
    return out


merge_splits.launches = 0  # kernel launches, read by chip_smoke.py


def _launch(a_keys, a_vals, b_keys, b_vals, lib=None):
    """The split pass and the tiles (of ``lib``, a variant from
    :func:`_kernel_lib`, else the default build), in one C call that
    checks each launch; raises on its first error."""
    lib = lib or _kernel_lib()
    dev = a_keys.device
    n = a_keys.numel() + b_keys.numel()
    splits = torch.empty(n_tiles(n, lib.gossamer_merge_tile()) + 1,
                         dtype=torch.int64, device=dev)
    out_keys = torch.empty(n, dtype=torch.int64, device=dev)
    out_vals = torch.empty(n, dtype=torch.int64, device=dev)
    err = lib.gossamer_merge_sorted(
        _device_index(dev), a_keys.data_ptr(), a_vals.data_ptr(),
        a_keys.numel(), b_keys.data_ptr(), b_vals.data_ptr(), b_keys.numel(),
        splits.data_ptr(), out_keys.data_ptr(), out_vals.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "merge_sorted kernel launch (merge_splits, merge_tiles)")
    if n:
        merge_splits.launches += 1
    merge_sorted.launches += 1
    return out_keys, out_vals


def merge_sorted_reference(a_keys: torch.Tensor, a_vals: torch.Tensor,
                           b_keys: torch.Tensor, b_vals: torch.Tensor):
    """Plain PyTorch :func:`merge_sorted`: a stable sort of A ++ B with the
    values gathered by the returned indices."""
    keys, order = torch.sort(torch.cat([a_keys, b_keys]), stable=True)
    return keys, torch.cat([a_vals, b_vals])[order]


def merge_splits_reference(a_keys: torch.Tensor, b_keys: torch.Tensor,
                           tile: int) -> torch.Tensor:
    """Plain PyTorch :func:`merge_splits`: the binary search of
    ``csrc/merge_path.cuh`` over every tile diagonal at once.  For
    ascending runs the split is unique, so the kernel, whatever its group
    of lanes a boundary, gives the same; for runs out of order both stay
    inside the runs and may differ."""
    na, nb = a_keys.numel(), b_keys.numel()
    n = na + nb
    dev = a_keys.device
    diag = torch.clamp(torch.arange(n_tiles(n, tile) + 1, device=dev) * tile,
                       max=n)
    lo = torch.clamp(diag - nb, min=0)
    hi = torch.clamp(diag, max=na)
    # hi - lo <= min(na, nb): that many bits of steps close every range
    for _ in range(min(na, nb).bit_length()):
        live = lo < hi
        mid = (lo + hi) >> 1
        take = (a_keys[mid.clamp(max=na - 1)]
                <= b_keys[(diag - 1 - mid).clamp(0, nb - 1)])
        lo = torch.where(live & take, mid + 1, lo)
        hi = torch.where(live & ~take, mid, hi)
    return lo
