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

A graph's counts leave the device as the graph file holds them
(:func:`file_counts`, then :func:`file_counts_host`): narrowed to
uint32 where they fit, with their histogram counted on the device.
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


# ------------------------------------------------------- a graph's counts
def file_counts(c: torch.Tensor):
    """A graph's int64 counts on the device -> ``(counts, hist)`` on the
    device, for one pull with the keys: what ``Graph.write`` and
    ``count_hist`` would make of them on the host.

    ``counts`` is the low 32 bits of each count as int32 (the file's
    uint32) where every count lies in ``[0, 2^32)``, else ``c`` itself
    (the file then holds int64).  ``hist`` is ``[mult, freq]``, the
    nonzero bins of ``torch.bincount`` (counter ``#hist_card``), where
    every count lies in ``[0, min(max(2^16, n), 2^31))`` for ``n`` counts:
    ``count_hist``'s counted rule, narrowed to what int32 holds.  Else
    ``[]``, and the host counts them.  The host reads one min and max."""
    if c.numel() == 0:
        return c.new_zeros(0, dtype=torch.int32), [c.new_zeros(0)] * 2
    with profile.context("sync"):
        low, top = torch.stack(torch.aminmax(c)).tolist()
    if low < 0 or top >= 1 << 32:
        return c, []
    # the even int32 words of a little-endian int64 are its low words
    c32 = c.contiguous().view(torch.int32)[::2].contiguous()
    if top >= min(max(1 << 16, c.numel()), 1 << 31):
        return c32, []
    profile.count("hist_card", 1)
    bins = torch.bincount(c32)
    mult = torch.nonzero(bins).squeeze(1)
    return c32, [mult, bins[mult]]


def file_counts_host(c: np.ndarray, hist: list):
    """The pulled arrays of :func:`file_counts` -> ``(counts, (mult, freq)
    or None)``: int32 bits as the file's uint32, the multiplicities in the
    counts' dtype, as ``count_hist`` gives them (int64 for no counts)."""
    if c.dtype == np.int32:
        c = c.view(np.uint32)
    if not hist:
        return c, None
    mult, freq = hist
    return c, (mult.astype(c.dtype) if len(c) else mult, freq)


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
