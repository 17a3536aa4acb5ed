"""K-mer counting engine for wide keys (31 < rho <= 63) on one torch device.

Counterpart of ``gossamer_tpu/ops/engine_wide.py``: the reference's
k <= 62 range (``src/Graph.hh:87-89``).  Same design as the JAX engine:
raw code chunks in, one sort per batch with the running spectrum
concatenated in, counts by cumsum difference mod 2^32, compaction by scan
and scatter.  No hand-written kernel runs here; the JAX wide engine is an
XLA sort program outside any Pallas kernel, and this one is PyTorch ops.

Key layout.  A key of up to 126 bits does not fit one int64 lane, so a
wide key travels in two forms:

* **limbs** ``(p3, p2, p1, p0)``: four int64 tensors holding 32-bit values
  in [0, 2^32), most significant first, the JAX engine's four uint32
  planes.  All bit arithmetic (k-merize, reverse complement, FNV hash)
  runs on limbs and masks every result, so nothing reaches bit 63
  (``>>`` and ``~`` on int64 are signed).
* **lanes** ``(hi, lo)``: two int64 tensors, ``hi = key >> 64`` (below 2^62)
  and ``lo = (key mod 2^64) xor 2^63``.  The flipped top bit makes signed
  comparison of ``lo`` agree with unsigned comparison of the low 64 bits,
  so ``(hi, lo)`` orders like the key under two signed comparisons.  Sorts,
  joins and the spectrum use lanes.  The sentinel is ``(2^63 - 1, 2^63 - 1)``:
  its ``hi`` is above every key's, also the all-``T`` rho-mer's at rho = 63
  (``hi = 2^62 - 1``), which a split into two 63-bit halves would make equal
  to an all-ones sentinel.

``torch.sort`` has one key, so :func:`sort_lanes` is a stable sort by ``lo``
followed by a stable sort by ``hi`` with everything else gathered.

Profile (``utils/profile.py``): scope ``wide/flush`` around each batch
step, ``sync`` around each read of a ``live``, ``spill`` around a spill
(counter ``#spill_runs``, one a spilled run), and the finish's phases
``flush_tail``, ``pull`` and ``expand`` as scopes; every pull to the host
goes through ``transfer.planes_to_host`` (``to_host``, ``#d2h_bytes``,
``#d2h_pinned_bytes``): a spectrum's planes in one pull.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profile
from .canon import FNV_OFFSET, M32, MODES, _fnv_step, _rev2_u32
from .kmerize import windows_without
from .transfer import (file_counts, file_counts_host, host_merge, merge_all,
                       planes_to_host, read_live, sync, to_device)

SENT = (1 << 63) - 1
TOP = -(1 << 63)  # the int64 whose only set bit is bit 63
Limbs = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def wide_keys(rho: int) -> bool:
    """2*rho in (62, 126]: more than one int64 lane, at most 126 bits."""
    return 62 < 2 * rho <= 126


# ------------------------------------------------------------ limbs <-> lanes
def to_lanes(p3, p2, p1, p0):
    """Limbs -> ``(hi, lo)`` lanes."""
    return (p3 << 32) | p2, (p1 - (1 << 31)) * (1 << 32) + p0


def from_lanes(hi: torch.Tensor, lo: torch.Tensor) -> Limbs:
    """``(hi, lo)`` lanes -> limbs.  The sentinel comes out as
    ``(2^31 - 1, 2^32 - 1, 2^32 - 1, 2^32 - 1)``."""
    return hi >> 32, hi & M32, ((lo >> 32) + (1 << 31)) & M32, lo & M32


def lanes_from_u64(lo: np.ndarray, hi: np.ndarray, device: torch.device):
    """Host key planes (numpy uint64 ``lo``, ``hi``) -> lanes on ``device``."""
    lo = np.ascontiguousarray(lo, np.uint64) ^ np.uint64(1 << 63)
    hi = np.ascontiguousarray(hi, np.uint64)
    return (torch.from_numpy(hi.view(np.int64)).to(device),
            torch.from_numpy(lo.view(np.int64)).to(device))


def u64_from_lanes(hi: torch.Tensor, lo: torch.Tensor, *payloads):
    """Lanes -> host key planes ``(lo, hi)`` as numpy uint64, then each
    payload as it is, all in one pull."""
    lo_u, hi_u, *rest = planes_to_host(lo ^ TOP, hi, *payloads)
    return lo_u.view(np.uint64), hi_u.view(np.uint64), *rest


def sort_lanes(hi: torch.Tensor, lo: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort by ``(hi, lo)``; payloads travel with their lanes."""
    lo, p = torch.sort(lo, stable=True)
    hi = hi[p]
    payloads = [x[p] for x in payloads]
    hi, p = torch.sort(hi, stable=True)
    return (hi, lo[p], *(x[p] for x in payloads))


# ------------------------------------------------------------------ k-merize
def kmerize_planes_wide(codes: torch.Tensor, rho: int):
    """uint8[..., C + rho - 1] codes (0-3 a base, anything else invalid) ->
    ``(p3, p2, p1, p0, valid)`` of the C windows, in natural order.

    The codes are packed on the device into big-endian 2-bit words of 16
    bases behind four zero words; window ``p`` is then the 128 stream bits
    that end after base ``p + rho - 1`` with the top ``128 - 2*rho`` bits
    masked off: one funnel shift per limb and phase, not a loop over the
    ``rho`` bases.
    """
    L = codes.shape[-1]
    C = L - rho + 1
    lead = codes.shape[:-1]
    bad = codes > 3
    valid = windows_without(bad, rho, C)
    C16 = -(-C // 16)
    n_words = C16 + 8  # 4 zero words, the stream, a zero tail
    flat = F.pad(torch.where(bad, 0, codes).to(torch.int64),
                 (64, n_words * 16 - 64 - L))
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=codes.device)
    words = (flat.view(*lead, n_words, 16) << shifts).sum(-1)

    z = 128 - 2 * rho  # zero bits above the key
    limbs: list[list[torch.Tensor]] = [[], [], [], []]
    for ph in range(16):
        o, s = divmod(ph + rho, 16)
        s *= 2
        for t in range(4):
            if 32 * (t + 1) <= z:
                continue  # this limb is zero
            a = words[..., o + t : o + t + C16]
            if s:
                b = words[..., o + t + 1 : o + t + 1 + C16]
                a = ((a << s) | (b >> (32 - s))) & M32
            if 32 * t < z:
                a = a & ((1 << (32 * (t + 1) - z)) - 1)
            limbs[t].append(a)
    out = []
    for phases in limbs:
        if phases:
            out.append(torch.stack(phases, dim=-1)
                       .reshape(*lead, C16 * 16)[..., :C])
        else:
            out.append(torch.zeros(*lead, C, dtype=torch.int64,
                                   device=codes.device))
    return (*out, valid)


# -------------------------------------------------------------- canonical forms
def _shr(limbs: Limbs, s: int) -> Limbs:
    """Right shift by the constant ``s`` of a 128-bit value in limbs."""
    out = list(limbs)
    w, r = divmod(s, 32)
    if w:
        out = [torch.zeros_like(out[0])] * w + out[: 4 - w]
    if r:
        shifted = []
        carry = None
        for x in out:
            y = x >> r
            if carry is not None:
                y = y | ((carry << (32 - r)) & M32)
            shifted.append(y)
            carry = x
        out = shifted
    return tuple(out)


def rc_planes_wide(p3, p2, p1, p0, rho: int) -> Limbs:
    """Reverse complement (``src/BigInteger.hh:193-216``): NOT, 2-bit
    reverse (the limb order flips), shift down by 128 - 2*rho."""
    n = tuple(_rev2_u32(x ^ M32) for x in (p0, p1, p2, p3))
    return _shr(n, 128 - 2 * rho)


def _less4(a: Limbs, b: Limbs) -> torch.Tensor:
    lt = a[3] < b[3]
    for x, y in ((a[2], b[2]), (a[1], b[1]), (a[0], b[0])):
        lt = (x < y) | ((x == y) & lt)
    return lt


def _select(take: torch.Tensor, a: Limbs, b: Limbs) -> Limbs:
    return tuple(torch.where(take, x, y) for x, y in zip(a, b))


def canon_value_wide(p3, p2, p1, p0, rho: int) -> Limbs:
    """min(x, rc(x)) by value."""
    x = (p3, p2, p1, p0)
    r = rc_planes_wide(*x, rho)
    return _select(_less4(r, x), r, x)


def fnv_planes_wide(p3, p2, p1, p0):
    """FNV-1a over the 16 little-endian bytes of the 128-bit value
    (``src/BigInteger.hh:528-536,572-582``) -> the hash as (hi32, lo32)
    int64 tensors."""
    h1 = torch.full_like(p0, FNV_OFFSET >> 32)
    h0 = torch.full_like(p0, FNV_OFFSET & M32)
    for word in (p0, p1, p2, p3):
        for i in range(4):
            h1, h0 = _fnv_step(h1, h0, (word >> (8 * i)) & 0xFF)
    return h1, h0


def canon_ref_wide(p3, p2, p1, p0, rho: int) -> Limbs:
    """The reference's canonical form: min by (FNV hash, value)
    (``src/RankSelect.hh:126-140``)."""
    x = (p3, p2, p1, p0)
    r = rc_planes_wide(*x, rho)
    fh, fl = fnv_planes_wide(*x)
    rh, rl = fnv_planes_wide(*r)
    less = (rh < fh) | ((rh == fh) & (rl < fl))
    same = (rh == fh) & (rl == fl)
    return _select(less | (same & _less4(r, x)), r, x)


def canonicalize_wide(limbs: Limbs, rho: int, mode: str) -> Limbs:
    if mode == "value":
        return canon_value_wide(*limbs, rho)
    if mode == "ref":
        return canon_ref_wide(*limbs, rho)
    if mode == "plain":
        return limbs
    raise ValueError(f"canonicalization mode {mode!r} not in {MODES}")


# ---------------------------------------------------------------- batch step
def _sort_count_compact_wide(hi, lo, w, cap: int):
    """Lanes with counts, in any order -> ``(hi[cap], lo[cap], c[cap],
    live)``: the distinct non-sentinel keys ascending with their counts
    summed mod 2^32, then sentinels with count 0.  ``live`` (0-d tensor,
    not synced) counts every group, also past ``cap``."""
    hi, lo, w = sort_lanes(hi, lo, w)
    S = torch.cumsum(w, 0) & M32
    n = hi.numel()
    ends = torch.ones(n, dtype=torch.bool, device=hi.device)
    ends[:-1] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    ends &= ~((hi == SENT) & (lo == SENT))
    live = ends.sum()
    dest = torch.cumsum(ends, 0) - 1
    slot = torch.where(ends & (dest < cap), dest, cap)  # lane cap: discard
    out = []
    for src, fill in ((hi, SENT), (lo, SENT), (S, 0)):
        t = torch.full((cap + 1,), fill, dtype=torch.int64, device=hi.device)
        out.append(t.scatter_(0, slot, src)[:cap])
    s_end = out[2]
    prev = torch.cat([s_end.new_zeros(1), s_end])[:cap]
    lane = torch.arange(cap, device=hi.device)
    counts = torch.where(lane < live, (s_end - prev) & M32, 0)
    return out[0].clone(), out[1].clone(), counts, live


def batch_step_wide(codes, s_hi, s_lo, s_c, rho: int, mode: str, cap: int):
    """Fold one batch of raw code chunks (uint8[B, C + rho - 1]) into the
    spectrum lanes -> ``(hi[cap], lo[cap], counts[cap], live)``."""
    *limbs, valid = kmerize_planes_wide(codes, rho)
    valid = valid.reshape(-1)
    limbs = canonicalize_wide(tuple(x.reshape(-1) for x in limbs), rho, mode)
    hi, lo = to_lanes(*limbs)
    hi = torch.where(valid, hi, SENT)
    lo = torch.where(valid, lo, SENT)
    return _sort_count_compact_wide(
        torch.cat([s_hi, hi]), torch.cat([s_lo, lo]),
        torch.cat([s_c, valid.to(torch.int64)]), cap)


def expand_step_wide(hi, lo, c, rho: int):
    """Canonical classes -> the symmetric fwd+rc spectrum of ``2 * cap``
    lanes; a palindrome appears once with its count doubled."""
    is_sent = (hi == SENT) & (lo == SENT)
    rhi, rlo = to_lanes(*rc_planes_wide(*from_lanes(hi, lo), rho))
    rhi = torch.where(is_sent, SENT, rhi)
    rlo = torch.where(is_sent, SENT, rlo)
    return _sort_count_compact_wide(
        torch.cat([hi, rhi]), torch.cat([lo, rlo]), torch.cat([c, c]),
        2 * hi.numel())


def empty_spec_wide(cap: int, device: torch.device):
    """All-sentinel wide spectrum of ``cap`` lanes: (hi, lo, counts)."""
    sent = torch.full((cap,), SENT, dtype=torch.int64, device=device)
    return sent, sent.clone(), torch.zeros(cap, dtype=torch.int64,
                                           device=device)


# --------------------------------------------------------------------- engine
class SpectrumEngineWide:
    """Host side of the wide count: stream raw code chunks (uint8, ``chunk +
    rho - 1`` codes each), keep a packed device spectrum in lanes.

    Same schedule as the narrow :class:`..engine.SpectrumEngine`: the device
    cap starts at the size of the first flush and grows by spilling and
    doubling up to ``cap``; flushes do not synchronize the host, which reads
    a ``live`` only when ``checked live + lanes inserted since`` could pass
    the cap.  A spectrum outgrowing the cap is pulled to host RAM as a
    sorted run (varint-delta encoded by the native 128-bit codec when the
    library is there) and the runs are merged at ``finish()``; with
    ``spill=False`` that raises instead.
    """

    def __init__(self, rho: int, mode: str, chunk: int, device: torch.device,
                 batch: int = 8, cap: int = 1 << 22, spill: bool = True,
                 on_spill=None):
        if not wide_keys(rho):
            raise ValueError(f"wide engine requires 62 < 2*rho <= 126 "
                             f"(rho={rho})")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.device = torch.device(device)
        self.batch = batch
        self.req_cap = cap
        self.cap = 0
        self.spill_enabled = spill
        self.on_spill = on_spill  # callback(run_index, run_len)
        self.spills = 0
        self.buf: list[np.ndarray] = []
        self.spec = None
        self.live_scalars: list[torch.Tensor] = []
        self.host_runs: list[tuple] = []
        self._checked_live = 0
        self._lanes_since_check = 0
        self.phases: dict[str, float] = {}  # seconds of the last finish
        self.hist = None  # finish_expanded's (mult, freq), where it made one

    def add_chunk(self, codes: np.ndarray) -> None:
        """Queue one raw code chunk (``io.stream.flat_code_chunks``)."""
        if len(codes) != self.chunk + self.rho - 1:
            raise ValueError(f"chunk of {len(codes)} codes, expected "
                             f"{self.chunk + self.rho - 1}")
        self.buf.append(codes)
        if len(self.buf) >= self.batch:
            self._flush()

    def start_from(self, hi: torch.Tensor, lo: torch.Tensor,
                   counts: torch.Tensor) -> None:
        """Continue from a packed spectrum in lanes, e.g. one carried over
        from the JAX engine with ``convert.wide_spectrum_from_planes``.  Its
        length becomes the device cap."""
        self.spec = tuple(t.to(self.device).contiguous()
                          for t in (hi, lo, counts))
        self.cap = hi.numel()
        self.req_cap = max(self.req_cap, self.cap)
        live = ((self.spec[0] != SENT) | (self.spec[1] != SENT)).sum()
        self.live_scalars = [live]
        self._checked_live = int(live)
        self._lanes_since_check = 0

    def _flush(self, final: bool = False) -> None:
        """Fold the queued chunks.  The final flush skips the spill
        schedule: no batch follows it, and ``finish()`` checks every
        ``live`` against the cap."""
        if not self.buf:
            return
        codes = to_device(np.stack(self.buf), self.device)
        batch_lanes = len(self.buf) * self.chunk
        self.buf = []
        want = min(self.req_cap, max(1 << 14, 2 * batch_lanes))
        if want > self.cap:
            if self.spec is not None and self.live_scalars:
                self._spill_to_host()
            self.cap = want
            self.spec = empty_spec_wide(self.cap, self.device)
        elif self.spec is None:
            self.spec = empty_spec_wide(self.cap, self.device)
        with profile.context("wide/flush"):
            *spec, live = batch_step_wide(codes, *self.spec, self.rho,
                                          self.mode, self.cap)
        self.spec = tuple(spec)
        self.live_scalars.append(live)
        if final:
            return
        self._lanes_since_check += batch_lanes
        bound = self._checked_live + self._lanes_since_check
        next_lanes = self.batch * self.chunk
        if bound + next_lanes > self.cap:
            self._checked_live = read_live(live)
            self._lanes_since_check = 0
            if self._checked_live > self.cap:
                raise RuntimeError(
                    f"distinct keys of one batch ({self._checked_live}) "
                    f"exceeded cap ({self.cap}); raise --spectrum-cap "
                    f"or lower --buffer-size")
            if self._checked_live + next_lanes > self.cap:
                if self.cap < self.req_cap:  # restart wider
                    self._spill_to_host()
                    self.cap = min(self.req_cap, 2 * self.cap)
                    self.spec = empty_spec_wide(self.cap, self.device)
                elif self.spill_enabled:
                    self._spill_to_host()
                else:
                    raise RuntimeError(
                        f"spectrum working set exceeded cap ({self.cap})")

    def _pull(self, spec, n_out: int):
        """The first ``n_out`` lanes -> host ``(lo u64, hi u64, c i64)``."""
        return u64_from_lanes(*(t[:n_out] for t in spec))

    def _live(self) -> int:
        n_out = read_live(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        return n_out

    def _spill_to_host(self) -> None:
        from ..io.native import NativeUnavailable, encode_spill_run128

        with profile.context("spill"):
            n_out = self._live()
            lo, hi, c = self._pull(self.spec, n_out)
            try:
                self.host_runs.append(("eac128",
                                       encode_spill_run128(lo, hi, c), n_out))
            except NativeUnavailable:
                self.host_runs.append(("raw", (lo, hi, c), n_out))
        self.spills += 1
        profile.count("spill_runs", 1)
        if self.on_spill is not None:
            self.on_spill(self.spills, n_out)
        self.spec = empty_spec_wide(self.cap, self.device)
        self.live_scalars = []
        self._checked_live = 0
        self._lanes_since_check = 0

    def _check_live(self) -> None:
        if not self.live_scalars:
            return
        with profile.context("sync"):
            max_live = int(torch.stack(self.live_scalars).max())
        if max_live > self.cap:
            raise RuntimeError(
                f"spectrum working set ({max_live}) exceeded cap "
                f"({self.cap}); rerun with a larger --spectrum-cap")

    def _merged_host(self):
        from ..io.native import decode_spill_run128

        runs = [decode_spill_run128(run, n) if kind == "eac128" else run
                for kind, run, n in self.host_runs]
        runs.append(self._pull(self.spec, self._live()))
        return merge_all(runs, host_merge, [], "on the host")

    def finish(self):
        """-> (lo u64, hi u64, counts i64), sorted by (hi, lo)."""
        self._flush(final=True)
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        if self.host_runs:
            return self._merged_host()
        return self._pull(self.spec, self._live())

    def finish_expanded(self, graph_counts: bool = False):
        """Finish and expand to the symmetric fwd+rc edge spectrum
        (build-graph semantics; mode 'value'): on the device when nothing
        spilled, over the live lanes only, on the host over the merged runs
        otherwise.  The phases' seconds are their scopes' (one clock reading
        each): ``flush_tail`` (the final flush), ``expand`` and ``pull``
        (the copy to the host; on the host side, the merges before the
        expansion).

        ``graph_counts`` (build-graph's write): an expansion on the device
        pulls the counts as the graph file holds them, and their histogram
        into :attr:`hist` (:func:`.transfer.file_counts`); the host's
        expansion gives int64 counts and leaves :attr:`hist` None."""
        with profile.context("flush_tail", clock=True) as tail:
            self._flush(final=True)
            sync(self.device)
        self.phases = {"flush_tail": tail.seconds}
        self.hist = None
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        if self.host_runs:
            from ..core import kmer as K

            with profile.context("pull", clock=True) as pull:
                lo, hi, c = self._merged_host()
            self.phases["pull"] = pull.seconds
            with profile.context("expand", clock=True) as expand:
                rlo, rhi = K.reverse_complement(lo, hi, self.rho)
                pal = (rlo == lo) & (rhi == hi)
                out_lo = np.concatenate([lo, rlo[~pal]])
                out_hi = np.concatenate([hi, rhi[~pal]])
                out_c = np.concatenate([np.where(pal, c * 2, c), c[~pal]])
                order = np.lexsort((out_lo, out_hi))
                out = out_lo[order], out_hi[order], out_c[order]
            self.phases["expand"] = expand.seconds
            return out
        with profile.context("expand", clock=True) as expand:
            n_live = self._live()
            *spec, live = expand_step_wide(*(t[:n_live] for t in self.spec),
                                           self.rho)
            n_out = read_live(live)
        self.phases["expand"] = expand.seconds
        with profile.context("pull", clock=True) as pull:
            if graph_counts:
                hi, lo, c = (t[:n_out] for t in spec)
                c, hist = file_counts(c)
                lo, hi, c, *hist = u64_from_lanes(hi, lo, c, *hist)
                c, self.hist = file_counts_host(c, hist)
                out = lo, hi, c
            else:
                out = self._pull(spec, n_out)
        self.phases["pull"] = pull.seconds
        return out
