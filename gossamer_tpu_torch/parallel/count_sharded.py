"""K-mer counting over several shards: data-parallel reads, hash-sharded
key space, one all-to-all exchange a flush.

Counterpart of ``gossamer_tpu/parallel/count_sharded.py``, the replacement
of the reference's single-node spill-and-merge scale story
(``src/GossCmdBuildKmerSet.tcc:246-328``, SURVEY.md section 2.10): instead of
spill files, shards exchange k-mers.

* **Data-parallel reads.**  Each shard k-merizes its own packed chunk.
* **Hash-partitioned key space.**  Shard ``s`` owns the keys whose mixed
  hash (:func:`mix_owner`, bit for bit the JAX package's) ends in ``s``,
  so every key lands on the same shard as there, and the bucket overflow
  and cap checks trip on the same inputs.
* **Routing.**  Lanes sort by (owner, key): a sort by key, then a stable
  sort by owner (the narrow key fills 62 bits of its int64 lane, so the
  owner is not packed into it).  Each destination's bucket is a fixed
  slice of ``per`` lanes past the destination's start, sentinel-padded;
  lanes past ``per`` are counted (``psum``, summed on the device over the
  flushes) and raise on the host at ``finish()``.  A lane's count travels
  implicitly: 1 for a key, 0 for the sentinel.
* **Fold.**  Each shard sorts the lanes it received and folds them into its
  spectrum with :func:`..ops.fold.merge_fold` (the merge-fold kernel on
  CUDA tensors), where the JAX package re-sorts the spectrum with the batch
  (``engine._sort_count_compact``, the same function).

``finish()`` merges the shard spectra (disjoint key sets) on the device
with one ``torch.sort``; build-graph's fwd+rc expansion then runs as on one
device (:func:`..ops.count._expand_symmetric`).  Wide keys
(:class:`ShardedSpectrumEngineWide`) take the same route over the
two-lane keys of :mod:`..ops.engine_wide` and PyTorch ops only.

Per flush each process feeds one chunk per local shard.  Under several
processes every flush starts with an all-reduce of who still has chunks,
so a process that has run out joins each exchange with empty chunks until
all have (the JAX package needs equal chunk counts).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import engine_wide as EW
from ..ops.canon import canonicalize
from ..ops.engine import narrow_keys
from ..ops.fold import SENT, merge_fold
from ..ops.kmerize import M32, kmerize_packed
from ..ops.transfer import sync, to_device
from . import mesh as M


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for x in [0, 2^32) held in int64, without
    overflowing int64: by 16-bit halves of the constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix(h: torch.Tensor, n_shards: int) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & (n_shards - 1)


def mix_owner(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of narrow int64 keys: the JAX package's murmur3-style
    u32 finalizer over the key's 32-bit planes (l1, l0), computed in int64
    masked to 32 bits.  Depends only on the key value."""
    l1, l0 = keys >> 32, keys & M32
    return _fmix(l0 ^ _mul32(l1, 0x9E3779B9), n_shards)


def mix_owner_wide(p3, p2, p1, p0, n_shards: int) -> torch.Tensor:
    """Owner shard of wide keys from their four 32-bit limbs (the JAX
    package's 4-limb hash)."""
    h = (p0 ^ _mul32(p1, 0x9E3779B9) ^ _mul32(p2, 0x85EBCA6B)
         ^ _mul32(p3, 0xC2B2AE35))
    return _fmix(h, n_shards)


def bucket_size(chunk: int, n: int, slack: int) -> int:
    """Lanes of one destination's bucket: ``slack`` times the even share."""
    return min(chunk, max(128, (slack * chunk) // n))


def _route(owner: torch.Tensor, lanes: list[torch.Tensor], n: int, per: int):
    """Lanes already ascending by key (sentinels last) -> for each
    destination its ``per`` lanes, sentinel-padded: ``[(n, per)]`` of each
    lane tensor, and the lanes that did not fit."""
    owner, p = torch.sort(owner, stable=True)
    lanes = [x[p] for x in lanes]
    # a scatter, not bincount: bincount reads the largest owner on the host
    cnts = torch.zeros(n, dtype=torch.int64, device=owner.device)
    cnts.index_add_(0, owner, torch.ones_like(owner))
    starts = torch.cumsum(cnts, 0) - cnts
    overflow = (cnts - per).clamp(min=0).sum()
    iota = torch.arange(per, device=owner.device)
    idx = starts[:, None] + iota[None, :]
    keep = iota[None, :] < cnts[:, None]
    pad = torch.full((per,), SENT, dtype=torch.int64, device=owner.device)
    return ([torch.where(keep, torch.cat([x, pad])[idx], SENT) for x in lanes],
            overflow)


def _local_route(words, inval, rho: int, chunk: int, mode: str, n: int,
                 per: int):
    """One shard's half of the flush before the exchange (``local_step``
    up to the ``all_to_all``): its packed chunk -> (keys bucketed by
    destination (n, per), lanes that overflowed their bucket)."""
    keys, valid = kmerize_packed(words, inval, rho, chunk)
    keys = canonicalize(keys, rho, mode)
    lane = torch.arange(chunk, device=keys.device)
    owner = torch.where(valid, mix_owner(keys, n), lane & (n - 1))
    keys, p = torch.sort(torch.where(valid, keys, SENT))
    (buckets,), overflow = _route(owner[p], [keys], n, per)
    return buckets, overflow


def _local_fold(received, s_keys, s_counts, cap_l: int):
    """One shard's half after the exchange: fold the received lanes into
    its spectrum -> (keys, counts, live)."""
    b = torch.sort(received.reshape(-1)).values
    return merge_fold(s_keys, s_counts, b, (b != SENT).to(torch.int64), cap_l)


class _Sharded:
    """What the narrow and wide engines share: the flush schedule over the
    mesh, the overflow and cap checks, and the pull of the shard spectra."""

    def __init__(self, mesh: M.Mesh, rho: int, mode: str, chunk: int,
                 cap: int, slack: int):
        n = mesh.size
        if n & (n - 1):
            raise ValueError(f"mix_owner partitions with '& (n-1)': the mesh "
                             f"size must be a power of two (got {n})")
        self.mesh = mesh
        self.n = n
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.cap_l = max(256, cap // n)
        self.per = bucket_size(chunk, n, slack)
        self.buf: list = []
        self.spec = None  # per local shard: its spectrum tensors
        self.live_scalars: list[list[torch.Tensor]] = []  # per flush
        self.overflow = None  # lanes past their bucket, summed over flushes
        self.spills = 0  # the sharded engines never spill
        self.phases: dict[str, float] = {}

    @property
    def _n_local(self) -> int:
        """Chunks this process feeds per flush: its local shard count."""
        return self.mesh.n_local

    def _empty_chunk(self):
        raise NotImplementedError

    def _step(self, items) -> None:
        raise NotImplementedError

    def _queue(self, item) -> None:
        self.buf.append(item)
        if len(self.buf) >= self._n_local:
            self._flush()

    def _flush(self, final: bool = False) -> None:
        if not self.mesh.distributed:
            if self.buf:
                self._run_step()
            return
        while True:
            active = M.psum(self.mesh, [torch.tensor(
                int(bool(self.buf)), device=self.mesh.home)])[0]
            if int(active) == 0:
                return
            self._run_step()
            if not final:
                return

    def _run_step(self) -> None:
        while len(self.buf) < self._n_local:  # pad to the local shards
            self.buf.append(self._empty_chunk())
        items, self.buf = self.buf, []
        self._step(items)

    def _add_overflow(self, per_shard: list[torch.Tensor]) -> None:
        total = M.psum(self.mesh, per_shard)[0]
        self.overflow = total if self.overflow is None else self.overflow + total

    def _check(self) -> list[int]:
        """Raise on any bucket overflow or any flush past the per-shard cap
        (max over ALL flushes, per shard: a transient mid-stream overflow
        crops the spectrum and could end back under the cap).  -> the last
        flush's live count of each local shard."""
        if self.overflow is not None and int(self.overflow) > 0:
            raise RuntimeError(
                "shard exchange bucket overflow — statistically "
                "impossible under hash partitioning at 2x slack; raise "
                "slack or report a bug")
        lives = [torch.stack([f[i].to(self.mesh.home)
                              for f in self.live_scalars])
                 for i in range(self._n_local)]
        top = M.pmax(self.mesh, [x.max() for x in lives])
        if int(top) > self.cap_l:
            raise RuntimeError(
                f"shard spectrum exceeded per-shard cap ({self.cap_l}); "
                f"rerun with a larger --spectrum-cap")
        return [int(x[-1]) for x in lives]


class ShardedSpectrumEngine(_Sharded):
    """Several-shard counterpart of :class:`..ops.engine.SpectrumEngine`:
    stream packed chunks, one per local shard a flush.

    ``mode`` as on one device ('value' for build-graph's canonical classes,
    'ref' for build-kmer-set, 'plain' for the forward strand).
    ``finish()``/``finish_expanded()`` return the single-device engine's
    spectrum.  ``cap`` is split into a per-shard cap ``max(256, cap // n)``
    that nothing spills past: overflowing it raises at ``finish()``.
    """

    def __init__(self, mesh: M.Mesh, rho: int, mode: str, chunk: int,
                 cap: int = 1 << 23, slack: int = 2):
        assert narrow_keys(rho) and rho <= 33
        assert chunk % 16 == 0
        super().__init__(mesh, rho, mode, chunk, cap, slack)
        C16 = chunk // 16
        self._geom = (C16 + 2, -(-(chunk + rho - 1) // 8))

    def add_chunk_packed(self, words: np.ndarray, inval: np.ndarray) -> None:
        self._queue((words, inval))

    def _empty_chunk(self):
        nw, nv = self._geom
        return np.zeros(nw, np.uint32), np.full(nv, 0xFF, np.uint8)

    def _step(self, items) -> None:
        devs = self.mesh.devices
        if self.spec is None:
            self.spec = [
                (torch.full((self.cap_l,), SENT, dtype=torch.int64, device=d),
                 torch.zeros(self.cap_l, dtype=torch.int64, device=d))
                for d in devs]
        routed = [_local_route(
            to_device(np.ascontiguousarray(w, np.uint32).view(np.int32), d),
            to_device(np.ascontiguousarray(v, np.uint8), d), self.rho,
            self.chunk, self.mode, self.n, self.per)
            for (w, v), d in zip(items, devs)]
        received = M.all_to_all(self.mesh, [b for b, _ in routed])
        folded = [_local_fold(r, *s, self.cap_l)
                  for r, s in zip(received, self.spec)]
        self.spec = [(k, c) for k, c, _ in folded]
        self.live_scalars.append([live for _, _, live in folded])
        self._add_overflow([o for _, o in routed])

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (lo u64, hi u64 zeros, counts i64), sorted."""
        t0 = time.perf_counter()
        self._flush(final=True)
        sync(self.mesh.home)
        self.phases = {"flush_tail": time.perf_counter() - t0}
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        t0 = time.perf_counter()
        live = self._check()
        keys = M.gather_rows(self.mesh, [k[:n] for (k, _), n in
                                         zip(self.spec, live)])
        counts = M.gather_rows(self.mesh, [c[:n] for (_, c), n in
                                           zip(self.spec, live)])
        # disjoint shard key sets: one sort gives the global order
        keys, order = torch.sort(torch.cat(keys))
        counts = torch.cat(counts)[order]
        sync(self.mesh.home)
        self.phases["merge"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lo = keys.cpu().numpy().view(np.uint64)
        out = lo, np.zeros_like(lo), counts.cpu().numpy()
        self.phases["pull"] = time.perf_counter() - t0
        return out

    def finish_expanded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Symmetric fwd+rc edge spectrum (build-graph semantics)."""
        from ..ops.count import _expand_symmetric

        lo, _hi, c = self.finish()
        if len(lo) == 0:
            return lo, _hi, c
        t0 = time.perf_counter()
        out = _expand_symmetric(lo, c, self.rho)
        self.phases["expand"] = time.perf_counter() - t0
        return out


# ---------------------------------------------------------------------------
# wide keys (31 < rho <= 63): the same route over the two-lane keys
# ---------------------------------------------------------------------------

def _local_route_wide(codes, rho: int, mode: str, n: int, per: int):
    """One shard's raw code chunk -> ((hi, lo) bucketed by destination,
    lanes that overflowed their bucket)."""
    *limbs, valid = EW.kmerize_planes_wide(codes, rho)
    limbs = EW.canonicalize_wide(tuple(limbs), rho, mode)
    lane = torch.arange(valid.numel(), device=codes.device)
    owner = torch.where(valid, mix_owner_wide(*limbs, n), lane & (n - 1))
    hi, lo = EW.to_lanes(*limbs)
    hi, lo, owner = EW.sort_lanes(torch.where(valid, hi, EW.SENT),
                                  torch.where(valid, lo, EW.SENT), owner)
    return _route(owner, [hi, lo], n, per)


class ShardedSpectrumEngineWide(_Sharded):
    """Wide-key engine: the contract of :class:`ShardedSpectrumEngine`, fed
    raw code chunks (uint8[chunk + rho - 1]); each shard keeps its spectrum
    in lanes and folds with the single-device wide engine's sort
    (PyTorch ops, no kernel, as in the JAX package)."""

    def __init__(self, mesh: M.Mesh, rho: int, mode: str, chunk: int,
                 cap: int = 1 << 22, slack: int = 2):
        assert EW.wide_keys(rho)
        super().__init__(mesh, rho, mode, chunk, cap, slack)

    def add_chunk(self, codes: np.ndarray) -> None:
        assert len(codes) == self.chunk + self.rho - 1
        self._queue(codes)

    def _empty_chunk(self):
        return np.full(self.chunk + self.rho - 1, 255, np.uint8)

    def _step(self, items) -> None:
        devs = self.mesh.devices
        if self.spec is None:
            self.spec = [EW.empty_spec_wide(self.cap_l, d) for d in devs]
        routed = [_local_route_wide(to_device(np.ascontiguousarray(
            c, np.uint8), d), self.rho, self.mode, self.n, self.per)
            for c, d in zip(items, devs)]
        r_hi = M.all_to_all(self.mesh, [b[0] for b, _ in routed])
        r_lo = M.all_to_all(self.mesh, [b[1] for b, _ in routed])
        folded = []
        for (s_hi, s_lo, s_c), h, l in zip(self.spec, r_hi, r_lo):
            h, l = h.reshape(-1), l.reshape(-1)
            c = ((h != EW.SENT) | (l != EW.SENT)).to(torch.int64)
            folded.append(EW._sort_count_compact_wide(
                torch.cat([s_hi, h]), torch.cat([s_lo, l]),
                torch.cat([s_c, c]), self.cap_l))
        self.spec = [f[:3] for f in folded]
        self.live_scalars.append([f[3] for f in folded])
        self._add_overflow([o for _, o in routed])

    def _merged(self):
        """The shard spectra merged on the device: (hi, lo, counts)."""
        live = self._check()
        parts = [M.gather_rows(self.mesh, [s[j][:n] for s, n in
                                           zip(self.spec, live)])
                 for j in range(3)]
        return EW.sort_lanes(*(torch.cat(p) for p in parts))

    def finish(self):
        """-> (lo u64, hi u64, counts i64), sorted by (hi, lo)."""
        self._flush(final=True)
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        hi, lo, c = self._merged()
        lo_u, hi_u = EW.u64_from_lanes(hi, lo)
        return lo_u, hi_u, c.cpu().numpy()

    def finish_expanded(self):
        """Symmetric fwd+rc edge spectrum (build-graph semantics), expanded
        on the device as on one device."""
        self._flush(final=True)
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        hi, lo, c = self._merged()
        if hi.numel() == 0:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        *spec, live = EW.expand_step_wide(hi, lo, c, self.rho)
        n_out = int(live)
        hi, lo, c = (x[:n_out] for x in spec)
        lo_u, hi_u = EW.u64_from_lanes(hi, lo)
        return lo_u, hi_u, c.cpu().numpy()
