"""Merge-fold of sorted key runs: the Hopper kernel and its plain version.

Counterpart of ``gossamer_tpu/ops/pallas_fold.py`` ``merge_fold_planes``.
:func:`merge_fold` merges the packed spectrum A with the sorted batch B,
sums the counts of equal keys mod 2^32, and packs the distinct
non-sentinel keys ascending into ``cap`` lanes.

* CUDA tensors launch ``csrc/fold.cu``, which replaces the Pallas kernel
  ``pallas_fold._fold_kernel``.  It is bound by device-memory bytes and
  makes one pass: A and B are read once (16 B a lane), merged once, and
  the output written once; the carry between tiles (group ends so far, the
  open group's count) travels by a chained scan with look-back, and the
  kernel checks the order of A and B itself (see the source).  Nothing
  else runs on the card around the launch.
* CPU tensors take :func:`merge_fold_reference`, the plain PyTorch
  version (the logic of ``engine._sort_count_compact``), and the order
  check in PyTorch.

The kernel library is built with ``nvcc`` into ``gossamer_tpu_torch/_build``
at first use (:mod:`.nvcc`) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .nvcc import build_library

SENT = (1 << 63) - 1  # sentinel key; above every narrow key (< 2^62)
M32 = 0xFFFFFFFF


@functools.cache
def _kernel_lib(**defines: int) -> ctypes.CDLL:
    """The kernel library; ``defines`` (``FOLD_THREADS``, ``FOLD_ITEMS``)
    build and load a variant with another tile, for tuning."""
    so, _, _ = build_library("fold", defines)
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.gossamer_merge_fold.restype = ctypes.c_int
    lib.gossamer_merge_fold.argtypes = [ctypes.c_int, vp, vp, ll, vp, vp, ll,
                                        ll, vp, vp, vp, vp, vp]
    for name in ("gossamer_fold_tile", "gossamer_fold_threads",
                 "gossamer_fold_blocks_per_sm", "gossamer_fold_profile_word"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.gossamer_fold_scratch_words.restype = ll
    lib.gossamer_fold_scratch_words.argtypes = [ll]
    lib.gossamer_cuda_error_string.restype = ctypes.c_char_p
    lib.gossamer_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _is_sorted(x: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: ``x`` ascending (no host sync)."""
    return torch.all(x[1:] >= x[:-1])


def _check(a_keys, a_counts, b_keys, b_counts, cap: int) -> None:
    dev = a_keys.device
    for name, t in (("a_keys", a_keys), ("a_counts", a_counts),
                    ("b_keys", b_keys), ("b_counts", b_counts)):
        if t.device != dev:
            raise ValueError(f"merge_fold: {name} on {t.device}, a_keys on {dev}")
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"merge_fold: {name} must be a contiguous 1-D "
                             f"int64 tensor (got {t.dtype}, shape "
                             f"{tuple(t.shape)})")
    if a_counts.numel() != a_keys.numel() or b_counts.numel() != b_keys.numel():
        raise ValueError("merge_fold: keys and counts differ in length")
    if cap < 0:
        raise ValueError(f"merge_fold: negative cap {cap}")


def merge_fold(a_keys: torch.Tensor, a_counts: torch.Tensor,
               b_keys: torch.Tensor, b_counts: torch.Tensor, cap: int):
    """Fold the sorted batch B into the packed spectrum A.

    A and B: ascending int64 keys with sentinels only at the tail; counts
    int64 in [0, 2^32), 0 on sentinel lanes.  Returns ``(keys[cap],
    counts[cap], live)``: the distinct non-sentinel keys ascending with
    counts summed mod 2^32, then sentinels with count 0.  ``live`` (0-d
    int64 tensor, never synced here) counts every group, also past
    ``cap``, so the caller can detect overflow; it is -1 when A or B was
    not ascending, and the engine raises when it reads that.
    """
    _check(a_keys, a_counts, b_keys, b_counts, cap)
    dev = a_keys.device
    if dev.type == "cpu":
        keys, counts, live = merge_fold_reference(a_keys, a_counts, b_keys,
                                                  b_counts, cap)
        ordered = _is_sorted(a_keys) & _is_sorted(b_keys)
        return keys, counts, torch.where(ordered, live, -1)
    if dev.type == "cuda":
        return _launch(a_keys, a_counts, b_keys, b_counts, cap)
    raise ValueError(f"merge_fold: no kernel for device {dev}")


merge_fold.launches = 0  # kernel launches, read by chip_smoke.py


def _launch(a_keys, a_counts, b_keys, b_counts, cap: int, lib=None,
            scratch=None):
    """Launch the kernel (of ``lib``, a variant from :func:`_kernel_lib`,
    else the default build).  The scratch (tile splits, the tile counter
    and the status words of the chained scan) is reset by the kernel; a
    caller that wants to read it afterwards passes its own."""
    lib = lib or _kernel_lib()
    dev = a_keys.device
    n = a_keys.numel() + b_keys.numel()
    out_keys = torch.empty(cap, dtype=torch.int64, device=dev)
    out_counts = torch.empty(cap, dtype=torch.int64, device=dev)
    live = torch.empty((), dtype=torch.int64, device=dev)
    if scratch is None:
        scratch = torch.empty(lib.gossamer_fold_scratch_words(n),
                              dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gossamer_merge_fold(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        a_keys.data_ptr(), a_counts.data_ptr(), a_keys.numel(),
        b_keys.data_ptr(), b_counts.data_ptr(), b_keys.numel(), cap,
        out_keys.data_ptr(), out_counts.data_ptr(), live.data_ptr(),
        scratch.data_ptr(), stream)
    if err != 0:
        msg = lib.gossamer_cuda_error_string(err).decode()
        raise RuntimeError(f"merge_fold kernel launch failed: {msg} ({err})")
    merge_fold.launches += 1
    return out_keys, out_counts, live


def merge_fold_reference(a_keys: torch.Tensor, a_counts: torch.Tensor,
                         b_keys: torch.Tensor, b_counts: torch.Tensor,
                         cap: int):
    """Plain PyTorch :func:`merge_fold`: concatenate, stable sort, group
    sums by cumsum difference, compact (``engine._sort_count_compact``).
    Needs no order in A or B and never syncs the host."""
    keys, order = torch.sort(torch.cat([a_keys, b_keys]), stable=True)
    S = torch.cumsum(torch.cat([a_counts, b_counts])[order], 0) & M32
    n = keys.numel()
    ends = torch.ones(n, dtype=torch.bool, device=keys.device)
    ends[:-1] = keys[1:] != keys[:-1]
    ends &= keys != SENT
    live = ends.sum()
    dest = torch.cumsum(ends, 0) - 1
    slot = torch.where(ends & (dest < cap), dest, cap)  # lane cap: discard
    out_keys = torch.full((cap + 1,), SENT, dtype=torch.int64,
                          device=keys.device)
    out_keys.scatter_(0, slot, keys)
    s_end = torch.zeros(cap + 1, dtype=torch.int64, device=keys.device)
    s_end.scatter_(0, slot, S)
    s_end = s_end[:cap]
    prev = torch.cat([s_end.new_zeros(1), s_end])[:cap]
    lane = torch.arange(cap, device=keys.device)
    counts = torch.where(lane < live, (s_end - prev) & M32, 0)
    return out_keys[:cap].clone(), counts, live
