#!/usr/bin/env python3
"""Tile tuning and time breakdown of the merge-fold kernel on one CUDA card.

    python3 scripts/fold_bench.py [--check] [--variants 128x27,256x8,...]
                                  [--old path/to/earlier/fold.cu]
                                  [--profile 128x27]

Builds ``gossamer_tpu_torch/csrc/fold.cu`` once per variant (threads a block
x lanes a thread, all nvcc started together), holds each against the plain
version on the smoke's edge cases (at that variant's tile) and at the shape
``goss build-graph`` gives the fold (``chip_smoke.fold_path_inputs``), and
times them in turns with CUDA events, twice round.  Prints for each variant
what ptxas reports, the blocks an SM holds, the time, the achieved GB/s in
the bound model (inputs once + outputs once) and the share of the bound,
then a ``torch.profiler`` breakdown of the default build by kernel.

``--check`` stops after the default build's comparison (the first run of a
changed kernel).  ``--old`` also times an earlier four-launch ``fold.cu``
(with the two PyTorch order passes its wrapper made) in the same turns.
``--profile`` builds one variant with ``-DFOLD_PROFILE`` and prints the mean
clock cycles a block's thread 0 spends in each phase of ``fold_tiles``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gossamer_tpu_torch.ops import fold, nvcc  # noqa: E402


def defines_of(variant: str) -> dict[str, int]:
    threads, items = variant.split("x")
    return {"FOLD_THREADS": int(threads), "FOLD_ITEMS": int(items)}


def old_runner(src: Path, a, ac, b, bc, cap):
    """The four-launch kernel of an earlier ``fold.cu`` with its wrapper's
    order passes; -> a function that runs it once."""
    so, _, log = nvcc.build_library("fold", src=src)
    print("\n".join(f"old {line}" for line in log.splitlines()
                    if "registers" in line), flush=True)
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.gossamer_merge_fold.restype = ctypes.c_int
    lib.gossamer_merge_fold.argtypes = [ctypes.c_int, vp, vp, ll, vp, vp, ll,
                                        ll, vp, vp, vp, vp, vp, vp, vp]
    lib.gossamer_fold_tile.restype = ctypes.c_int
    dev = a.device
    nblk = -(-(a.numel() + b.numel()) // lib.gossamer_fold_tile())

    def run():
        ordered = fold._is_sorted(a) & fold._is_sorted(b)
        out_keys = torch.empty(cap, dtype=torch.int64, device=dev)
        out_counts = torch.empty(cap, dtype=torch.int64, device=dev)
        live = torch.empty((), dtype=torch.int64, device=dev)
        blk_sum = torch.empty(nblk, dtype=torch.int32, device=dev)
        blk_ends = torch.empty(nblk, dtype=torch.int64, device=dev)
        sbuf = torch.empty(cap, dtype=torch.int32, device=dev)
        err = lib.gossamer_merge_fold(
            dev.index or 0, a.data_ptr(), ac.data_ptr(), a.numel(),
            b.data_ptr(), bc.data_ptr(), b.numel(), cap, out_keys.data_ptr(),
            out_counts.data_ptr(), live.data_ptr(), blk_sum.data_ptr(),
            blk_ends.data_ptr(), sbuf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"old merge_fold launch failed ({err})")
        return out_keys, out_counts, torch.where(ordered, live, -1)

    return run


PHASES = ("tile id, splits, copies started", "waiting for the slices",
          "order check and merge", "block scan", "compaction", "look-back",
          "stores sent",
          "(of the look-back: until the tile just before had published)")


def profile_phases(variant: str, a, ac, b, bc, cap) -> None:
    lib = fold._kernel_lib(**defines_of(variant), FOLD_PROFILE=1)
    n = a.numel() + b.numel()
    scratch = torch.empty(lib.gossamer_fold_scratch_words(n),
                          dtype=torch.int64, device=a.device)
    for _ in range(3):
        fold._launch(a, ac, b, bc, cap, lib, scratch)
    torch.cuda.synchronize()
    w = lib.gossamer_fold_profile_word()
    cycles = scratch[w : w + len(PHASES)].tolist()
    ntiles = -(-n // lib.gossamer_fold_tile())
    print(f"{variant}: mean clock cycles of thread 0 per tile, by phase "
          f"({ntiles} tiles, {lib.gossamer_fold_blocks_per_sm()} blocks an "
          f"SM), total {sum(cycles[:7]) / ntiles:.0f}:", flush=True)
    for name, c in zip(PHASES, cycles):
        print(f"  {c / ntiles:9.0f}  {name}", flush=True)


def check_variant(lib, dev, inputs) -> None:
    """Edge cases at this variant's tile and the path's shape, exactly."""
    tile = lib.gossamer_fold_tile()
    cases, unsorted = chip_smoke.fold_edge_cases(dev, tile)
    for name, (a, ac, b, bc, cap) in cases.items():
        got = fold._launch(a, ac, b, bc, cap, lib)
        want = fold.merge_fold_reference(a, ac, b, bc, cap)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            chip_smoke.check(torch.equal(g, w), f"tile {tile}: kernel == "
                                                f"plain, {name}")
    for name, (a, ac, b, bc, cap) in unsorted.items():
        live = int(fold._launch(a, ac, b, bc, cap, lib)[2])
        chip_smoke.check(live == -1, f"tile {tile}: live = -1, {name}")
    a, ac, b, bc, _ = inputs
    want = fold.merge_fold_reference(a, ac, b, bc, chip_smoke.CAP)
    for rep in range(3):
        got = fold._launch(a, ac, b, bc, chip_smoke.CAP, lib)
        torch.cuda.synchronize()
        chip_smoke.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                         f"tile {tile}: kernel == plain at the path's shape "
                         f"(run {rep}, live {int(got[2])})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants", default="128x27,128x25,128x21,128x15,256x9,256x8,512x8")
    ap.add_argument("--old", type=Path)
    ap.add_argument("--profile", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fold_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(subprocess.run(["nvcc", "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1], flush=True)

    so, secs, log = nvcc.build_library("fold")
    print(f"default build: {secs:.1f} s\n{log}", flush=True)
    inputs = chip_smoke.fold_path_inputs(dev, 2)
    a, ac, b, bc, _ = inputs
    cap = chip_smoke.CAP
    check_variant(fold._kernel_lib(), dev, inputs)
    if args.check:
        return 0

    variants = args.variants.split(",")
    with ThreadPoolExecutor(len(variants)) as ex:
        logs = list(ex.map(
            lambda v: nvcc.build_library("fold", defines_of(v))[2], variants))
    runners = {}
    for v, log in zip(variants, logs):
        lib = fold._kernel_lib(**defines_of(v))
        used = [line.split("Used ")[1] for line in log.splitlines()
                if "Used" in line]
        print(f"{v}: tile {lib.gossamer_fold_tile()}, "
              f"{lib.gossamer_fold_blocks_per_sm()} blocks an SM; ptxas "
              f"(init, tiles, fill in source order as listed): {used}",
              flush=True)
        check_variant(lib, dev, inputs)
        runners[v] = (lambda lib=lib: fold._launch(a, ac, b, bc, cap, lib))
    runners["wrapper, default build"] = lambda: fold.merge_fold(a, ac, b, bc, cap)
    if args.old:
        runners["old four-launch kernel + order passes"] = old_runner(
            args.old, a, ac, b, bc, cap)

    times = {v: [] for v in runners}
    for _ in range(2):
        for v, run in runners.items():
            times[v].append(chip_smoke.time_ms(run))
    model = chip_smoke.fold_bound(a.numel(), b.numel(), cap)
    print(f"bound model {model['bytes']} B -> {model['bound_ms']:.4f} ms on "
          f"{smi}", flush=True)
    for v, ts in times.items():
        ms = min(ts)
        print(f"{v}: {ms:.4f} ms (runs {ts}) = "
              f"{model['bytes'] / ms / 1e6:.0f} GB/s, "
              f"{100 * model['bound_ms'] / ms:.1f}% of the bound", flush=True)

    for variant in args.profile:
        profile_phases(variant, a, ac, b, bc, cap)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fold.merge_fold(a, ac, b, bc, cap)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12,
                                    max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
