"""Copies between host memory and a torch device, and the host side of a
finish's sorted runs, for both count engines and the sharded count.

Every copy to the device is counted (``#h2d_bytes``) and, to a CUDA
device, leaves from pinned memory without blocking the host.  Every pull
to the host goes through :func:`planes_to_host`: the planes of one pull
land in one page-locked block of torch's caching host allocator, carved
into aligned views, the host waiting once (scope ``to_host``, counters
``#d2h_bytes`` and ``#d2h_pinned_bytes``).  A read of a device scalar
(:func:`read_live`) and a wait for the device (:func:`sync`) are scope
``sync``.

A finish merges its sorted runs two at a time, smallest first
(:func:`merge_all`); on the host the merge of two runs is
:func:`host_merge`, over one key plane (narrow keys) or two (wide keys).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profile

ALIGN = 64  # bytes: where each carved view of a pinned block starts


# ------------------------------------------------------------ to the device
def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    profile.count("h2d_bytes", arr.nbytes)
    t = torch.from_numpy(arr)
    if device.type == "cuda":  # pinned, so the copy does not block the host
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stack_to_device(arrays, device: torch.device) -> torch.Tensor:
    """Host arrays of one shape -> one device tensor; uint32 travels as its
    int32 view (every consumer masks to 32 bits or holds values < 2^31)."""
    out = np.stack(arrays)
    return to_device(out.view(np.int32) if out.dtype == np.uint32 else out,
                     device)


def run_to_device(lo: np.ndarray, c: np.ndarray, device: torch.device):
    return (to_device(np.ascontiguousarray(lo).view(np.int64), device),
            to_device(np.ascontiguousarray(c, np.int64), device))


# -------------------------------------------------------------- to the host
def aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def carve(block: torch.Tensor, tensors) -> list:
    """Views of the uint8 ``block``, one a tensor, of its dtype and shape,
    each starting on an ``ALIGN``-byte boundary."""
    views, off = [], 0
    for t in tensors:
        views.append(block[off:off + t.nbytes].view(t.dtype).view(t.shape))
        off += aligned(t.nbytes)
    return views


def planes_to_host(*tensors: torch.Tensor) -> list:
    """Tensors pulled to host memory, the host waiting once for the work
    queued before the copies: scope ``to_host``, counter ``#d2h_bytes``.

    From a CUDA device the copies land in one page-locked block of torch's
    caching host allocator, carved by :func:`carve` (counter
    ``#d2h_pinned_bytes``).  Each array's base is its view of the block,
    so the block goes back to the cache only when the last array is gone.
    CPU tensors come back as ``.numpy()``."""
    for t in tensors:
        profile.count("d2h_bytes", t.nbytes)
    with profile.context("to_host"):
        if tensors[0].device.type != "cuda":
            return [t.cpu().numpy() for t in tensors]
        size = sum(aligned(t.nbytes) for t in tensors)
        block = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        dst = carve(block, tensors)
        for d, t in zip(dst, tensors):
            profile.count("d2h_pinned_bytes", t.nbytes)
            d.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return [d.numpy() for d in dst]


def to_host(t: torch.Tensor) -> np.ndarray:
    """One tensor pulled to host memory by :func:`planes_to_host`."""
    return planes_to_host(t)[0]


def run_to_host(keys: torch.Tensor, counts: torch.Tensor):
    k, c = planes_to_host(keys, counts)
    return k.view(np.uint64), c


# ------------------------------------------------------------------- waits
def sync(device: torch.device) -> None:
    if device.type == "cuda":
        with profile.context("sync"):
            torch.cuda.synchronize(device)


def read_live(live: torch.Tensor) -> int:
    with profile.context("sync"):
        n = int(live)  # device sync
    if n < 0:
        raise RuntimeError("merge_fold inputs were not ascending (live = -1)")
    return n


# -------------------------------------------------------------- sorted runs
def host_merge(a, b):
    """Two sorted host runs ``(*key planes, counts)``: ``(lo, c)`` or, for
    wide keys, ``(lo, hi, c)`` ordered by ``(hi, lo)`` -> their union, the
    counts of equal keys summed."""
    *keys, c = (np.concatenate([x, y]) for x, y in zip(a, b))
    if len(c) == 0:
        return (*keys, c)
    order = np.lexsort(keys)  # stable, the last plane first
    keys = [k[order] for k in keys]
    new = np.zeros(len(c), dtype=bool)
    new[0] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return (*(k[new] for k in keys), np.add.reduceat(c[order],
                                                     np.flatnonzero(new)))


def merge_all(runs: list, merge, log: list, side: str):
    """Merge ``runs`` two at a time, smallest first (as the JAX engine's
    ``_merged_host``) with ``merge(a, b)`` -> one run; each merge logged."""
    while len(runs) > 1:
        runs.sort(key=lambda r: len(r[0]))
        a, b = runs.pop(0), runs.pop(0)
        log.append(f"merge of {len(a[0]):,} + {len(b[0]):,} keys {side}")
        runs.append(merge(a, b))
        del a, b  # the inputs go before the next merge
    return runs[0]
