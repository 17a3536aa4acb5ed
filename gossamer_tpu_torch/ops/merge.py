"""Merge of two sorted key runs: the Hopper kernel and its plain version.

Counterpart of ``gossamer_tpu/ops/pallas_merge.py`` ``merge_sorted_planes``.
:func:`merge_sorted` merges two ascending int64 runs of (key, value) lanes
into one ascending run of nA + nB lanes; values travel with their keys and
nothing is deduplicated.  On equal keys A's lanes come first, so the result
is a stable sort of A ++ B.

* CUDA tensors launch ``csrc/merge.cu``, which replaces the Pallas kernel
  ``pallas_merge._merge_kernel``.  It is bound by device-memory bytes: one
  pass reading and writing (nA + nB) x 16 B (see the source).
* CPU tensors take :func:`merge_sorted_reference`, the plain PyTorch
  version: a stable sort of the concatenation.

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


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    so, _, _ = build_library("merge")
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.gossamer_merge_sorted.restype = ctypes.c_int
    lib.gossamer_merge_sorted.argtypes = [ctypes.c_int, vp, vp, ll, vp, vp, ll,
                                          vp, vp, vp]
    lib.gossamer_merge_error_string.restype = ctypes.c_char_p
    lib.gossamer_merge_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(a_keys, a_vals, b_keys, b_vals) -> None:
    dev = a_keys.device
    for name, t in (("a_keys", a_keys), ("a_vals", a_vals),
                    ("b_keys", b_keys), ("b_vals", b_vals)):
        if t.device != dev:
            raise ValueError(f"merge_sorted: {name} on {t.device}, a_keys on "
                             f"{dev}")
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"merge_sorted: {name} must be a contiguous 1-D "
                             f"int64 tensor (got {t.dtype}, shape "
                             f"{tuple(t.shape)})")
    if a_vals.numel() != a_keys.numel() or b_vals.numel() != b_keys.numel():
        raise ValueError("merge_sorted: keys and values differ in length")


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


def _launch(a_keys, a_vals, b_keys, b_vals):
    lib = _kernel_lib()
    dev = a_keys.device
    n = a_keys.numel() + b_keys.numel()
    out_keys = torch.empty(n, dtype=torch.int64, device=dev)
    out_vals = torch.empty(n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gossamer_merge_sorted(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        a_keys.data_ptr(), a_vals.data_ptr(), a_keys.numel(),
        b_keys.data_ptr(), b_vals.data_ptr(), b_keys.numel(),
        out_keys.data_ptr(), out_vals.data_ptr(), stream)
    if err != 0:
        msg = lib.gossamer_merge_error_string(err).decode()
        raise RuntimeError(f"merge_sorted kernel launch failed: {msg} ({err})")
    merge_sorted.launches += 1
    return out_keys, out_vals


def merge_sorted_reference(a_keys: torch.Tensor, a_vals: torch.Tensor,
                           b_keys: torch.Tensor, b_vals: torch.Tensor):
    """Plain PyTorch :func:`merge_sorted`: a stable sort of A ++ B with the
    values gathered by the returned indices."""
    keys, order = torch.sort(torch.cat([a_keys, b_keys]), stable=True)
    return keys, torch.cat([a_vals, b_vals])[order]
