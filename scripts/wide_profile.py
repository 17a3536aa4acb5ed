#!/usr/bin/env python3
"""Device time by op of one wide flush and one wide classify batch.

    python3 scripts/wide_profile.py [--rho 56] [-K 40] [--top 14]

Runs on one CUDA card, with ``torch.profiler``:

* one flush of the wide counting engine at the CLI's shape
  (``batch_step_wide``: 8 chunks of 2^22 windows of seeded random codes with
  a read separator every 101 codes, mode ``value``, folded into a spectrum
  of the CLI's default cap that already holds one such batch);
* one wide classify batch (``classify_batch_wide``: a window of 2^19 codes
  holding 4096 reads of 100 bases, joined to a set of 9.2M seeded random
  ``E`` lanes, the size of the smoke's xenome index);
* beside them the narrow counterparts at the same shapes
  (``batch_step_packed`` at rho 26 with the fold kernel,
  ``classify_batch_packed`` at K 25 with the merge kernel), in the same call.

Prints the card's name and power limit, each step's device time (the sum of
its kernels' device time in the profile, and CUDA events around the call),
and the kernels that take most of it, so that one can tell whether a 128-bit
merge kernel would pay.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def profile_step(name: str, fn, smi: str, top: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = chip_smoke.time_ms(fn, reps=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # a kernel's time appears twice: on the kernel's own row and on the row
    # of the PyTorch op that launched it; kernels launched through ctypes
    # have no op row
    total = sum(e.self_device_time_total for e in events
                if e.device_type == cuda) / 1e3
    launches = sum(e.count for e in events if e.device_type == cuda)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in events
            if e.device_type != cuda]
    outside = total - sum(r[2] for r in rows)
    if outside > 1e-3:
        rows.append(("(kernels launched outside a PyTorch op)", 0, outside))
    rows.sort(key=lambda r: -r[2])
    print(f"{name} on {smi}: {ms:.2f} ms by CUDA events; profiler: "
          f"{total:.2f} ms of device time in {launches} kernel launches, by "
          f"op:", flush=True)
    if total == 0:
        print("  (the profiler saw no device time here)", flush=True)
    for key, count, t in rows[:top]:
        print(f"  {t:9.3f} ms {100 * t / total:5.1f}%  x{count:<5d} {key[:100]}",
              flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rho", type=int, default=chip_smoke.WIDE_RHO)
    ap.add_argument("-K", type=int, default=chip_smoke.WIDE_XK)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from gossamer_tpu_torch.classify import device as cd
    from gossamer_tpu_torch.io.stream import pack_chunk
    from gossamer_tpu_torch.ops import engine, engine_wide as ew, fold

    dev = torch.device("cuda", 0)
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    cap, chunk, batch = chip_smoke.CAP, chip_smoke.CHUNK, chip_smoke.BATCH
    g = torch.Generator(device=dev).manual_seed(7)

    def codes_batch(rho):
        codes = torch.randint(0, 4, (batch, chunk + rho - 1), device=dev,
                              generator=g, dtype=torch.uint8)
        codes[:, ::101] = 255
        return codes

    # ---- the flush
    rho = args.rho
    *spec, live = ew.batch_step_wide(codes_batch(rho),
                                     *ew.empty_spec_wide(cap, dev), rho,
                                     "value", cap)
    codes = codes_batch(rho)
    profile_step(f"wide flush (rho {rho}, {batch} x {chunk} windows into {cap} "
                 f"lanes holding {int(live)} keys)",
                 lambda: ew.batch_step_wide(codes, *spec, rho, "value", cap),
                 smi, args.top)
    del spec, codes

    nrho = chip_smoke.RHO
    rng = np.random.default_rng(7)
    packed = []
    for _ in range(batch):
        c = rng.integers(0, 4, chunk + nrho - 1).astype(np.uint8)
        c[::101] = 255
        packed.append(pack_chunk(c, nrho, chunk))
    words = torch.from_numpy(np.stack([w for w, _ in packed]).view(np.int32)).to(dev)
    inval = torch.from_numpy(np.stack([v for _, v in packed])).to(dev)
    keys, counts, live = engine.batch_step_packed(
        words, inval, *engine.empty_spec(cap, dev), nrho, "value", cap, chunk)
    nspec = (keys, counts)
    profile_step(f"narrow flush (rho {nrho}, the same shape, {int(live)} keys "
                 f"held; {fold.merge_fold.launches} fold launches so far)",
                 lambda: engine.batch_step_packed(words, inval, *nspec, nrho,
                                                  "value", cap, chunk),
                 smi, args.top)
    del nspec, words, inval, keys, counts

    # ---- the classify batch
    n_set, window, n_reads, L = 9_182_371, 1 << 19, 4096, 100
    k = args.K
    flat = np.full(window + k - 1, 255, np.uint8)
    flat[: n_reads * (L + 1)].reshape(n_reads, L + 1)[:, :L] = rng.integers(
        0, 4, (n_reads, L))
    starts = torch.arange(n_reads, dtype=torch.int64, device=dev) * (L + 1)
    set_hi = torch.sort(torch.randint(0, 1 << (2 * k + 2 - 64), (n_set,),
                                      device=dev, generator=g)).values
    set_lo = torch.randint(-(1 << 62), 1 << 62, (n_set,), device=dev,
                           generator=g) * 2
    set_hi, set_lo = ew.sort_lanes(set_hi, set_lo)
    dcodes = torch.from_numpy(flat).to(dev)
    max_reads = window // 32
    profile_step(f"wide classify batch (K {k}, {n_reads} reads in a window of "
                 f"{window}, set of {n_set} lanes)",
                 lambda: cd.classify_batch_wide(dcodes, starts, set_hi, set_lo,
                                                k, max_reads),
                 smi, args.top)
    nk = chip_smoke.XK
    nflat = flat[: window + nk - 1]
    w, v = pack_chunk(nflat, nk, window)
    set_E = torch.sort(torch.randint(0, 1 << (2 * nk + 2), (n_set,), device=dev,
                                     generator=g)).values
    dw = torch.from_numpy(w.view(np.int32)).to(dev)
    dv = torch.from_numpy(v).to(dev)
    profile_step(f"narrow classify batch (K {nk}, the same shape)",
                 lambda: cd.classify_batch_packed(dw, dv, starts, set_E, nk,
                                                  max_reads, window),
                 smi, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
