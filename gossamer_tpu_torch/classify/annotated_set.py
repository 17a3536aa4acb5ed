"""Annotated k-mer sets: union set + per-source membership bits.

Counterpart of ``gossamer_tpu/classify/annotated_set.py``.  The xenome
index structure (``src/GossCmdMergeAndAnnotateKmerSets.cc:120-205``): a
union KmerSet plus two bit vectors ``.lhs-bits`` / ``.rhs-bits`` marking
which source(s) each k-mer came from, refined by ``compute-near-kmers``
(``src/GossCmdComputeNearKmers.cc:58-147``), which clears both bits on
"marginal" k-mers that have a near neighbour in the opposite class.

:class:`AnnotatedKmerSet` and :func:`merge_and_annotate` are host copies
(any key width).  :func:`near_kmers` (k <= 31, one int64 lane a key) and
:func:`near_kmers_wide` (k <= 62, the two-lane layout of
:mod:`..ops.engine_wide`) run on the torch device of their tensors;
:func:`compute_near_kmers_host` is the JAX package's numpy version, kept
as the reference the device versions are held against.  The set algebra
of ``goss merge-kmer-sets`` / ``intersect-kmer-sets`` /
``subtract-kmer-set`` (:func:`merge_sets`, :func:`intersect_sets`,
:func:`subtract_sets`) is host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import kmer as K
from ..graph.kmer_set import KmerSet
from ..io.artifacts import read_array, write_array
from ..io.factory import FileFactory

U64 = np.uint64


class AnnotatedKmerSet:
    def __init__(self, kset: KmerSet, lhs_bits: np.ndarray, rhs_bits: np.ndarray):
        self.kset = kset
        self.lhs = lhs_bits.astype(bool)
        self.rhs = rhs_bits.astype(bool)

    # -- persistence -------------------------------------------------------
    def write(self, basename: str, fac: FileFactory) -> None:
        self.kset.write(basename, fac)
        write_array(fac, basename + ".lhs-bits", self.lhs)
        write_array(fac, basename + ".rhs-bits", self.rhs)

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "AnnotatedKmerSet":
        ks = KmerSet.read(basename, fac)
        return cls(
            ks,
            read_array(fac, basename + ".lhs-bits"),
            read_array(fac, basename + ".rhs-bits"),
        )


def merge_and_annotate(lhs: KmerSet, rhs: KmerSet) -> tuple[AnnotatedKmerSet, int]:
    """Union of two sorted canonical sets + membership bits.

    Returns (annotated set, number of common k-mers); the reference's
    2-cursor merge becomes a sorted union + two membership queries.
    """
    if lhs.k != rhs.k:
        raise ValueError("cannot merge k-mer sets with different K")
    lo = np.concatenate([lhs.lo, rhs.lo])
    hi = np.concatenate([lhs.hi, rhs.hi])
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    if len(lo):
        keep = np.ones(len(lo), dtype=bool)
        keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi = lo[keep], hi[keep]
    union = KmerSet(lhs.k, lo, hi)
    lhs_bits, _ = lhs.access_and_rank(lo, hi) if lhs.count else (np.zeros(len(lo), bool), None)
    rhs_bits, _ = rhs.access_and_rank(lo, hi) if rhs.count else (np.zeros(len(lo), bool), None)
    common = int((lhs_bits & rhs_bits).sum())
    return AnnotatedKmerSet(union, lhs_bits, rhs_bits), common


def _probe_masks(k: int) -> list[int]:
    """x ^ (b << j) for b in 1..3 and *bit* offset j in 0..K-1: the
    reference shifts by j, not 2j, so only the low K bits are mutated
    (``GossCmdComputeNearKmers.cc:84-86``); kept for parity."""
    return [b << j for j in range(k) for b in (1, 2, 3)]


def near_kmers(keys: torch.Tensor, lhs: torch.Tensor, rhs: torch.Tensor,
               k: int, batch: int = 1 << 22) -> torch.Tensor:
    """Marginal k-mers of an annotated union set, on the tensors' device.

    ``keys``: the set's k-mers as ascending int64 (narrow, 2k <= 62);
    ``lhs``/``rhs``: bool membership bits.  Returns bool[n]: an exclusive
    k-mer x (lhs != rhs) is marginal iff some normalized probe of x is
    present, exclusive, and of the opposite class
    (``GossCmdComputeNearKmers.cc:70-110``).  Exclusive k-mers are probed
    ``batch`` at a time.
    """
    from ..ops.canon import canon_ref

    if 2 * k > 62:
        raise ValueError(f"wide keys (k={k} > 31) go through near_kmers_wide")
    n = keys.numel()
    gray = torch.zeros(n, dtype=torch.bool, device=keys.device)
    excl = torch.nonzero(lhs != rhs).squeeze(1)
    for s in range(0, excl.numel(), batch):
        idx = excl[s : s + batch]
        x = keys[idx]
        x_lhs = lhs[idx]
        found = torch.zeros_like(x_lhs)
        for m in _probe_masks(k):
            y = x ^ m
            y_n = canon_ref(y, k)
            r = torch.searchsorted(keys, y_n).clamp_(max=n - 1)
            hit = keys[r] == y_n
            r_lhs = lhs[r]
            found |= (y != x) & hit & (r_lhs != rhs[r]) & (r_lhs != x_lhs)
        gray[idx] = found
    return gray


def near_kmers_wide(hi: torch.Tensor, lo: torch.Tensor, lhs: torch.Tensor,
                    rhs: torch.Tensor, k: int,
                    batch: int = 1 << 22) -> torch.Tensor:
    """:func:`near_kmers` for keys of up to 124 bits: ``(hi, lo)`` are the
    set's k-mers as ascending lanes of :mod:`..ops.engine_wide`.  A probe
    mask has bit offsets below k, so it changes the two low limbs only; each
    probe's normalized k-mers are looked up by a sort-join against the set
    (:func:`.device.join_wide`), since ``torch.searchsorted`` has one key."""
    from ..ops import engine_wide as ew
    from .device import join_wide

    gray = torch.zeros(hi.numel(), dtype=torch.bool, device=hi.device)
    excl = torch.nonzero(lhs != rhs).squeeze(1)
    set_excl = lhs != rhs
    for s in range(0, excl.numel(), batch):
        idx = excl[s : s + batch]
        p3, p2, p1, p0 = ew.from_lanes(hi[idx], lo[idx])
        x_lhs = lhs[idx]
        found = torch.zeros_like(x_lhs)
        for m in _probe_masks(k):
            y = ew.canon_ref_wide(p3, p2, p1 ^ (m >> 32), p0 ^ (m & ew.M32), k)
            r = join_wide(hi, lo, *ew.to_lanes(*y))
            rc = r.clamp(min=0)
            found |= (r >= 0) & set_excl[rc] & (lhs[rc] != x_lhs)
        gray[idx] = found
    return gray


def compute_near_kmers(ann: AnnotatedKmerSet, device: torch.device) -> int:
    """Clear both bits on the marginal k-mers of ``ann`` (:func:`near_kmers`
    or, above k = 31, :func:`near_kmers_wide`, on ``device``).  Returns the
    number of marginal ("gray") k-mers."""
    ks = ann.kset
    lhs = torch.from_numpy(ann.lhs).to(device)
    rhs = torch.from_numpy(ann.rhs).to(device)
    if 2 * ks.k <= 62:
        keys = torch.from_numpy(ks.lo.view(np.int64)).to(device)
        gray = near_kmers(keys, lhs, rhs, ks.k)
    else:
        from ..ops.engine_wide import lanes_from_u64

        gray = near_kmers_wide(*lanes_from_u64(ks.lo, ks.hi, device), lhs,
                               rhs, ks.k)
    gray = gray.cpu().numpy()
    ann.lhs = ann.lhs & ~gray
    ann.rhs = ann.rhs & ~gray
    return int(gray.sum())


def compute_near_kmers_host(ann: AnnotatedKmerSet, batch: int = 1 << 16) -> int:
    """The JAX package's host ``compute_near_kmers`` (numpy, any width):
    the reference :func:`compute_near_kmers` is held against."""
    ks = ann.kset
    k = ks.k
    excl = np.nonzero(ann.lhs != ann.rhs)[0]
    gray_total = 0
    new_lhs = ann.lhs.copy()
    new_rhs = ann.rhs.copy()
    for s in range(0, len(excl), batch):
        idx = excl[s : s + batch]
        xlo = ks.lo[idx]
        xhi = ks.hi[idx]
        x_lhs = ann.lhs[idx]
        found = np.zeros(len(idx), dtype=bool)
        for m in _probe_masks(k):
            ylo = xlo ^ U64(m & ((1 << 64) - 1))
            yhi = xhi ^ U64(m >> 64)
            changed = (ylo != xlo) | (yhi != xhi)
            nlo, nhi, _ = K.normalize(ylo, yhi, k)
            hit, r = ks.access_and_rank(nlo, nhi)
            safe_r = np.minimum(r, max(ks.count - 1, 0))
            r_excl = ann.lhs[safe_r] != ann.rhs[safe_r]
            opp = ann.lhs[safe_r] != x_lhs
            found |= changed & hit & r_excl & opp
        gray_total += int(found.sum())
        new_lhs[idx[found]] = False
        new_rhs[idx[found]] = False
    ann.lhs = new_lhs
    ann.rhs = new_rhs
    return gray_total


# ---------------------------------------------------------------- set ops
def _as_sorted_unique(lo, hi):
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    if len(lo):
        keep = np.ones(len(lo), dtype=bool)
        keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi = lo[keep], hi[keep]
    return lo, hi


def merge_sets(sets: list[KmerSet]) -> KmerSet:
    """Union of N sets (``goss merge-kmer-sets``)."""
    k = sets[0].k
    lo = np.concatenate([s.lo for s in sets])
    hi = np.concatenate([s.hi for s in sets])
    lo, hi = _as_sorted_unique(lo, hi)
    return KmerSet(k, lo, hi)


def intersect_sets(a: KmerSet, b: KmerSet) -> KmerSet:
    hit, _ = b.access_and_rank(a.lo, a.hi)
    return KmerSet(a.k, a.lo[hit], a.hi[hit])


def subtract_sets(a: KmerSet, b: KmerSet) -> KmerSet:
    hit, _ = b.access_and_rank(a.lo, a.hi)
    return KmerSet(a.k, a.lo[~hit], a.hi[~hit])
