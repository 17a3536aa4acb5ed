"""Graph walks over a mesh: chain pointer doubling and prune-tips.

Counterpart of ``gossamer_tpu/parallel/walk_sharded.py``:

* the successor/predecessor tables come from live-weighted rank queries
  over the contiguously sharded edges: a dead-aware lower bound is the sum
  of the live weights before the key (the ``originalRank`` trick of the
  host :class:`..graph.trimmer.TrimView`), here one ``torch.searchsorted``
  into the gathered table and an exclusive ``cumsum`` of its weights;
* chains resolve by pointer doubling over the mesh: each round every shard
  ``all_gather``s the current jump table and advances its own block,
  ``O(log L)`` rounds instead of the reference's per-thread walks
  (``src/GossCmdPruneTips.cc:290-312``, ``src/Graph.tcc:21-46``);
* the tip decision (length, attachment and sibling-coverage gates of
  ``src/GossCmdPruneTips.cc:93-254``) is taken for every chain head on its
  own shard.

The loop of :func:`sharded_prune_tips_masks` applies the relative-cutoff
gate (the host pass's float64 expression) and assembles the zap mask
elementwise from the gathered outputs, on the device, then iterates with
the accumulated live mask: the surviving edges are the host TrimView
pass's, byte for byte.

Narrow keys only (2*rho <= 62), as the rest of the sharded layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.canon import rc
from . import mesh as M
from .cleanup_sharded import shard_planes


def _to_node(keys: torch.Tensor, rho: int) -> torch.Tensor:
    """Edge (2*rho bits) -> to-node (its low 2*(rho-1) bits)."""
    return keys & ((1 << (2 * (rho - 1))) - 1)


def _ranks_joined(T: torch.Tensor, wcum: torch.Tensor, q: torch.Tensor):
    """Against the whole sorted table T (sentinels at its tail) with the
    exclusive prefix sums ``wcum`` of its per-key weights: per query the
    plain lower-bound rank and the weighted one (the sum of the weights of
    the keys before it)."""
    plain = torch.searchsorted(T, q)
    return plain, wcum[plain]


def _first_live_slot(r0, r1, LIVE):
    """First rank in [r0, r1) (r1 - r0 <= 4) whose LIVE flag is set, or -1."""
    N = LIVE.numel()
    out = torch.full_like(r0, -1)
    for j in (3, 2, 1, 0):
        idx = (r0 + j).clamp(max=N - 1)
        hit = (r0 + j < r1) & (LIVE[idx] == 1)
        out = torch.where(hit, idx, out)
    return out


def _link_tables(keys, live, rho: int, T, wcum, LIVE):
    """Per-edge link and degree tables of one shard's block from one joined
    rank pass (9 query streams): (nxt, prev_slot, rcr, outd_to, ind_to,
    outd_from, ind_from), ``nxt``/``prev_slot`` with the dead-aware
    semantics of :meth:`TrimView.successor_table` (the caller turns
    ``prev_slot`` into the previous edge through the gathered ``rcr``)."""
    k = rho - 1
    t = _to_node(keys, rho)
    f = keys >> 2
    tA, tC = t << 2, rc(t, k) << 2
    fE, fG = f << 2, rc(f, k) << 2
    q = torch.cat([tA, tA + 4, tC, tC + 4, fE, fE + 4, fG, fG + 4,
                   rc(keys, rho)])
    plain, wgt = _ranks_joined(T, wcum, q)
    B = keys.numel()
    p = plain.view(9, B)
    w = wgt.view(9, B)
    outd_to, ind_to = w[1] - w[0], w[3] - w[2]
    outd_from, ind_from = w[5] - w[4], w[7] - w[6]
    rcr = p[8]
    through = (outd_to == 1) & (ind_to == 1) & (live == 1)
    nxt = torch.where(through, _first_live_slot(p[0], p[1], LIVE), -1)
    pf_through = (outd_from == 1) & (ind_from == 1) & (live == 1)
    prev_slot = torch.where(pf_through, _first_live_slot(p[6], p[7], LIVE), -1)
    return nxt, prev_slot, rcr, outd_to, ind_to, outd_from, ind_from


def _gathered(mesh: M.Mesh, xs):
    """``all_gather(x).reshape(-1)`` on each shard."""
    return [g.reshape(-1) for g in M.all_gather(mesh, xs)]


def _double(mesh: M.Mesh, ptr, rounds: int):
    """Pointer doubling over the mesh: per shard (jump, dist) of each edge
    toward the chain end in ``ptr``'s direction; ``rounds`` all_gather
    rounds cover chains of up to 2**rounds edges."""
    jump, dist = [], []
    for i, p in enumerate(ptr):
        B = p.numel()
        self_rank = (mesh.offset + i) * B + torch.arange(B, device=p.device)
        jump.append(torch.where(p >= 0, p, self_rank))
        dist.append((p >= 0).to(torch.int64))
    for _ in range(rounds):
        JUMP = _gathered(mesh, jump)
        DIST = _gathered(mesh, dist)
        dist = [d + D[j] for d, D, j in zip(dist, DIST, jump)]
        jump = [J[j] for J, j in zip(JUMP, jump)]
    return jump, dist


def _chains(mesh: M.Mesh, keys, live, rho: int, rounds: int):
    """What the tip pass and the segment table share: the gathered tables,
    the link tables, and both doublings -> dict of per-shard lists."""
    T = _gathered(mesh, keys)
    LIVE = _gathered(mesh, live)
    wcum = [torch.cat([L.new_zeros(1), torch.cumsum(L, 0)]) for L in LIVE]
    links = [_link_tables(k_, l_, rho, T_, w_, L_)
             for k_, l_, T_, w_, L_ in zip(keys, live, T, wcum, LIVE)]
    nxt, prev_slot, rcr, outd_to, ind_to, outd_from, ind_from = (
        [x[j] for x in links] for j in range(7))
    # prev edge = rc of the unique live out-edge of rc(from(e))
    RCR = _gathered(mesh, rcr)
    prev = [torch.where(s >= 0, R[s.clamp(min=0)], -1)
            for s, R in zip(prev_slot, RCR)]
    jump, dist = _double(mesh, prev, rounds)
    PREV = _gathered(mesh, prev)
    resolved = [P[j] < 0 for P, j in zip(PREV, jump)]
    jmpE, distE = _double(mesh, nxt, rounds)
    NXT = _gathered(mesh, nxt)
    resolved_end = [X[j] < 0 for X, j in zip(NXT, jmpE)]
    return dict(T=T, LIVE=LIVE, wcum=wcum, prev=prev, rcr=rcr,
                outd_to=outd_to, ind_to=ind_to, outd_from=outd_from,
                ind_from=ind_from, jump=jump, dist=dist, resolved=resolved,
                jmpE=jmpE, distE=distE, resolved_end=resolved_end)


def _tip_pass(mesh: M.Mesh, keys, live, cnt, rho: int, rounds: int,
              cutoff: int | None):
    """One sharded prune-tips pass (``make_tip_pass``) -> gathered
    (is_head, cand, c_cov, total, jump, resolved, rcr) over all lanes: the
    gates of ``GossCmdPruneTips.cc:93-254`` but the relative cutoff, which
    :func:`sharded_prune_tips_masks` applies."""
    k = rho - 1
    ch = _chains(mesh, keys, live, rho, rounds)
    CNT = _gathered(mesh, cnt)
    OUTD_TO = _gathered(mesh, ch["outd_to"])
    IND_TO = _gathered(mesh, ch["ind_to"])
    outs = []
    for i in range(mesh.n_local):
        T, LIVE, wcum = ch["T"][i], ch["LIVE"][i], ch["wcum"][i]
        jmpE = ch["jmpE"][i]
        is_head = (live[i] == 1) & (ch["prev"][i] < 0)
        seg_len = ch["distE"][i] + 1
        tip_ok = ch["resolved_end"][i] & (seg_len <= 2 * k)
        start_ok = ch["ind_from"][i] == 0
        beg_con = ch["outd_from"][i] > 1
        end_con = (IND_TO[i][jmpE] > 1) | (OUTD_TO[i][jmpE] > 0)
        joined_end = ~beg_con & end_con
        joined_beg = beg_con & ~end_con
        cand = is_head & start_ok & tip_ok & (joined_end | joined_beg)
        c_cov = torch.where(joined_end, CNT[i][jmpE], cnt[i])
        if cutoff is not None and cutoff > 0:
            cand = cand & (c_cov >= cutoff)
        # attach node: rc(to(end)) when joined at the end, else from(head)
        att = torch.where(joined_end, rc(_to_node(T[jmpE], rho), k),
                          keys[i] >> 2)
        r0a, _ = _ranks_joined(T, wcum, att << 2)
        r1a, _ = _ranks_joined(T, wcum, (att << 2) + 4)
        N = T.numel()
        ok = torch.ones_like(cand)
        total = torch.zeros_like(c_cov)
        for j in range(4):
            idx = (r0a + j).clamp(max=N - 1)
            live_s = (r0a + j < r1a) & (LIVE[idx] == 1)
            cov = CNT[i][idx]
            ok = ok & ~(live_s & (cov < c_cov))
            total = total + torch.where(live_s, cov, 0)
        cand = cand & ok
        outs.append((is_head, cand, c_cov, total, ch["jump"][i],
                     ch["resolved"][i], ch["rcr"][i]))
    return [_gathered(mesh, [o[j] for o in outs])[0] for j in range(7)]


def sharded_prune_tips_masks(mesh: M.Mesh, lo: np.ndarray,
                             counts: np.ndarray, rho: int,
                             iterations: int = 1,
                             cutoff: int | None = None,
                             relative_cutoff: float | None = None,
                             log=None) -> np.ndarray:
    """Iterated prune-tips entirely by mesh walks -> the dead mask over the
    original rank space (apply with ``Graph.remove_edges``).  The same
    surviving edges as the host TrimView pass: the relative-cutoff gate is
    its float64 expression."""
    keys, c, n = shard_planes(lo, counts, mesh.size)
    if n == 0:
        return np.zeros(0, bool)
    k = rho - 1
    rounds = max(1, int(np.ceil(np.log2(2 * k + 2))) + 1)
    kd, cd = M.put(mesh, keys), M.put(mesh, c)
    live = torch.zeros(keys.size, dtype=torch.int64, device=mesh.home)
    live[:n] = 1
    for it in range(iterations):
        is_head, cand, c_cov, total, jump, resolved, rcr = _tip_pass(
            mesh, kd, M.put(mesh, live.view(mesh.size, -1)), cd, rho,
            rounds, cutoff)
        if relative_cutoff is not None and relative_cutoff > 0:
            # the host pass's expression (algo/cleanup.py), in float64
            cand = cand & ~(c_cov.to(torch.float64)
                            < total.to(torch.float64) * relative_cutoff)
        qualify = cand & is_head
        member = (live == 1) & resolved & qualify[jump]
        # rcr of a padded lane is no edge's: keep it in range
        zap = member | member[rcr.clamp(max=live.numel() - 1)]
        tips = int(qualify.sum())
        if log is not None:
            log("info", f"prune-tips pass {it + 1}: removed {tips} tips "
                        f"({int(zap.sum())} edges) [mesh]")
        if tips == 0:
            break
        live[zap] = 0
    return (live[:n] == 0).cpu().numpy()


def sharded_segment_table(mesh: M.Mesh, lo: np.ndarray, rho: int,
                          live: np.ndarray | None = None):
    """Chain decomposition of the (live) edges by mesh pointer doubling
    (``make_segment_fn``; the segment table of TourBus pass 1 and
    EntryEdgeSet, ``src/TourBus.cc:366-420``,
    ``src/EntryEdgeSet.cc:154-290``).  -> (head, pos, end, len_from_here,
    cyclic) numpy arrays over the original rank space: ``head[e]``/
    ``pos[e]`` place e in its chain, ``end[head]``/``len_from_here[head] +
    1`` give the chain's end edge and length; ``cyclic`` marks isolated
    cycles (never resolved to a head)."""
    keys, _c, n = shard_planes(lo, None, mesh.size)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(bool)
    rounds = max(1, int(np.ceil(np.log2(n + 1))) + 1)
    lv = np.zeros(keys.size, np.int64)
    lv[:n] = 1 if live is None else np.asarray(live, np.int64)
    ch = _chains(mesh, M.put(mesh, keys), M.put(mesh, lv.reshape(keys.shape)),
                 rho, rounds)
    jump, dist, jmpE, distE, resolved = (
        _gathered(mesh, ch[name])[0].cpu().numpy()[:n]
        for name in ("jump", "dist", "jmpE", "distE", "resolved"))
    return jump, dist, jmpE, distE, ~resolved
