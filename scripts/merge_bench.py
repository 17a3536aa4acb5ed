#!/usr/bin/env python3
"""Tile tuning and time breakdown of the merge kernel on one CUDA card.

    python3 scripts/merge_bench.py [--check] [--variants 256x7x3,384x7x2,...]
                                   [--groups 1,2,4,8,16,32]
                                   [--old path/to/earlier/merge.cu]
                                   [--profile 512x5x3]

Builds ``gossamer_tpu_torch/csrc/merge.cu`` once per variant (threads a block
x lanes a thread x stages of the ring, ``-DMERGE_THREADS``, ``-DMERGE_ITEMS``,
``-DMERGE_STAGES``; all nvcc started together), holds each against the plain
version on the edge cases of ``tests/merge_cases.py`` at that variant's
tile (``chip_smoke.merge_edge_cases``) and at the four shapes the paths give
the merge (``chip_smoke.merge_shapes``), and times them in turns with CUDA
events, twice round, beside a device-to-device copy of the same bytes (read
16 B and write 16 B a lane, as the merge does).  Prints for each variant what
ptxas reports and the blocks an SM holds, then at each shape every variant's
time, achieved GB/s in the bound model (inputs once + outputs once) and share
of the bound, and the split pass alone; then a ``torch.profiler`` breakdown
of the default build by kernel.

It also builds the default tile with each of ``--groups`` lanes a tile
boundary in the split pass (``-DMERGE_SPLIT_GROUP``), holds each build
against the plain version, and prints at each shape the split pass's device
time alone (torch.profiler) and the whole merge's time (CUDA events, in
turns) for every group beside the default build's.  ``--check`` stops
after the default build's comparison (the first run of a changed kernel).
``--old`` also times an earlier one-kernel ``merge.cu`` (one block a tile,
each block searching its own splits; its C entry point
``gossamer_merge_sorted``) in the same turns.  ``--profile`` builds one
variant with ``-DMERGE_PROFILE`` and prints, at each shape, the mean clock
cycles that thread 0 of a block spends in each phase of ``merge_tiles`` a
tile.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gossamer_tpu_torch.ops import merge, nvcc  # noqa: E402


def defines_of(variant: str) -> dict[str, int]:
    threads, items, stages = variant.split("x")
    return {"MERGE_THREADS": int(threads), "MERGE_ITEMS": int(items),
            "MERGE_STAGES": int(stages)}


def old_runner(src: Path, a, av, b, bv):
    """The one-launch kernel of an earlier ``merge.cu`` -> a function that
    runs it once."""
    so, _, log = nvcc.build_library("merge", src=src)
    print("\n".join(f"old {line}" for line in log.splitlines()
                    if "registers" in line), flush=True)
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.gossamer_merge_sorted.restype = ctypes.c_int
    lib.gossamer_merge_sorted.argtypes = [ctypes.c_int, vp, vp, ll, vp, vp, ll,
                                          vp, vp, vp]
    dev = a.device
    n = a.numel() + b.numel()

    def run():
        out_keys = torch.empty(n, dtype=torch.int64, device=dev)
        out_vals = torch.empty(n, dtype=torch.int64, device=dev)
        err = lib.gossamer_merge_sorted(
            dev.index or 0, a.data_ptr(), av.data_ptr(), a.numel(),
            b.data_ptr(), bv.data_ptr(), b.numel(), out_keys.data_ptr(),
            out_vals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"old merge_sorted launch failed ({err})")
        return out_keys, out_vals

    return run


PHASES = ("waiting for the tile's slices (wait_group, barrier)",
          "starting the copies of a later tile",
          "merge path and merge into registers",
          "write-back into the stage (two barriers)",
          "stores issued")


def profile_phases(variant: str, dev, shapes) -> None:
    lib = merge._kernel_lib(**defines_of(variant), MERGE_PROFILE=1)
    tile = lib.gossamer_merge_tile()
    resident = (merge.blocks_per_sm(lib, dev)
                * torch.cuda.get_device_properties(dev).multi_processor_count)
    words = (ctypes.c_ulonglong * merge.PROFILE_WORDS)()
    reps = 3
    for what, (a, av, b, bv) in shapes.items():
        merge._launch(a, av, b, bv, lib)
        merge._raise_on(lib, lib.gossamer_merge_profile(dev.index or 0, None, 1),
                        "profile reset")
        for _ in range(reps):
            merge._launch(a, av, b, bv, lib)
        merge._raise_on(lib, lib.gossamer_merge_profile(dev.index or 0, words, 0),
                        "profile read")
        ntiles = merge.n_tiles(a.numel() + b.numel(), tile)
        blocks = min(ntiles, resident)
        per_tile = [w / (reps * ntiles) for w in words[: len(PHASES)]]
        print(f"{variant} at {what}: {ntiles} tiles over {blocks} blocks "
              f"({ntiles / blocks:.1f} a block); mean clock cycles of thread 0 "
              f"a tile, total {sum(per_tile):.0f}; prologue "
              f"{words[5] / (reps * blocks):.0f} a block:", flush=True)
        for name, c in zip(PHASES, per_tile):
            print(f"  {c:9.0f}  {name}", flush=True)


def split_device_ms(a, b, lib, reps: int = 10) -> float:
    """Device time of one split pass of ``lib`` at its tile, from
    torch.profiler (the wrapper's host time exceeds it)."""
    from torch.profiler import ProfilerActivity, profile

    tile = lib.gossamer_merge_tile()
    merge.merge_splits(a, b, tile, lib)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            merge.merge_splits(a, b, tile, lib)
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if "merge_splits" in e.key)
    return us / reps / 1e3


def check_variant(lib, dev, shapes) -> None:
    """Edge cases at this variant's tile and the four shapes, exactly."""
    tile = lib.gossamer_merge_tile()
    resident = (merge.blocks_per_sm(lib, dev)
                * torch.cuda.get_device_properties(dev).multi_processor_count)
    cases = chip_smoke.merge_edge_cases(dev, tile, resident)
    for name, args in [*cases.items(), *shapes.items()]:
        got = merge._launch(*args, lib=lib)
        want = merge.merge_sorted_reference(*args)
        splits = merge.merge_splits(args[0], args[2], tile, lib)
        want_splits = merge.merge_splits_reference(args[0], args[2], tile)
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1])
                         and torch.equal(splits, want_splits),
                         f"tile {tile}: kernel == plain, splits == plain, "
                         f"{name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants",
                    default="256x7x3,256x9x2,384x7x2,512x5x2,1024x3x2")
    ap.add_argument("--groups", default="1,2,4,8,16,32")
    ap.add_argument("--old", type=Path)
    ap.add_argument("--profile", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("merge_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(subprocess.run(["nvcc", "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1], flush=True)

    variants = [] if args.check else args.variants.split(",")
    groups = [] if args.check else [int(g) for g in args.groups.split(",")]
    builds = [({}, "default"), *((defines_of(v), v) for v in variants),
              *(({"MERGE_SPLIT_GROUP": g}, f"split group {g}")
                for g in groups),
              *((dict(defines_of(v), MERGE_PROFILE=1), f"{v} profile")
                for v in args.profile)]
    with ThreadPoolExecutor(len(builds)) as ex:
        logs = list(ex.map(lambda d: nvcc.build_library("merge", d[0]), builds))
    for (_d, name), (_so, secs, log) in zip(builds, logs):
        used = [line.split("Used ")[1] for line in log.splitlines()
                if "Used" in line]
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"{name}: nvcc {secs:.1f} s; ptxas (merge_splits, merge_tiles in "
              f"the order listed): {used}; {spills}", flush=True)

    shapes = chip_smoke.merge_shapes(dev, per_shard=True)
    default = merge._kernel_lib()
    print(f"default: {chip_smoke.merge_kernel_info(dev)}", flush=True)
    check_variant(default, dev, shapes)
    if args.check:
        return 0

    libs = {}
    for v in variants:
        lib = merge._kernel_lib(**defines_of(v))
        print(f"{v}: tile {lib.gossamer_merge_tile()}, "
              f"{lib.gossamer_merge_smem_bytes()} B of shared memory, "
              f"{merge.blocks_per_sm(lib, dev)} blocks an SM", flush=True)
        check_variant(lib, dev, shapes)
        libs[v] = lib
    by_group = {}
    for g in groups:
        by_group[g] = merge._kernel_lib(MERGE_SPLIT_GROUP=g)
        check_variant(by_group[g], dev, shapes)

    for what, (a, av, b, bv) in shapes.items():
        n = a.numel() + b.numel()
        src = torch.empty(2 * n, dtype=torch.int64, device=dev)
        dst = torch.empty_like(src)
        runners = {v: (lambda lib=lib: merge._launch(a, av, b, bv, lib))
                   for v, lib in libs.items()}
        runners["wrapper, default build"] = (
            lambda: merge.merge_sorted(a, av, b, bv))
        if args.old:
            runners["old one-launch kernel"] = old_runner(args.old, a, av, b, bv)
            old_got = runners["old one-launch kernel"]()
            new_got = merge.merge_sorted(a, av, b, bv)
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(old_got[0], new_got[0])
                             and torch.equal(old_got[1], new_got[1]),
                             f"old kernel == new kernel at {what}")
        runners["device-to-device copy of the same bytes"] = (
            lambda: dst.copy_(src))
        runners["split pass alone (default tile)"] = (
            lambda: merge.merge_splits(a, b, default.gossamer_merge_tile()))
        times = {v: [] for v in runners}
        for _ in range(2):
            for v, run in runners.items():
                times[v].append(chip_smoke.time_ms(run))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            merge.merge_sorted(a, av, b, bv)
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        model = chip_smoke.merge_bound(a.numel(), b.numel())
        print(f"{what}: A {a.numel()} + B {b.numel()} lanes; bound model "
              f"{model['bytes']} B -> {model['bound_ms']:.4f} ms on {smi}; "
              f"the wrapper's host time a call (enqueue) {host_us:.1f} us",
              flush=True)
        for v, ts in times.items():
            ms = min(ts)
            print(f"  {v}: {ms:.4f} ms (runs {[round(t, 4) for t in ts]}) = "
                  f"{model['bytes'] / ms / 1e6:.0f} GB/s, "
                  f"{100 * model['bound_ms'] / ms:.1f}% of the bound",
                  flush=True)
        del src, dst

    for variant in args.profile:
        profile_phases(variant, dev, shapes)

    tile = default.gossamer_merge_tile()
    for what, (a, av, b, bv) in shapes.items():
        alone = {g: split_device_ms(a, b, lib) for g, lib in by_group.items()}
        runs = {"default": default, **by_group}
        merged = {g: [] for g in runs}
        for _ in range(2):
            for g in (*runs, *reversed(runs)):
                merged[g].append(chip_smoke.time_ms(
                    lambda lib=runs[g]: merge._launch(a, av, b, bv, lib)))
        print(f"split pass at {what} "
              f"({merge.n_tiles(a.numel() + b.numel(), tile) + 1} boundaries; "
              f"the default build takes {default.gossamer_merge_split_group()} "
              f"lanes a boundary): by lanes a boundary, the pass alone "
              f"(device ms, torch.profiler) "
              f"{ {g: round(t, 4) for g, t in alone.items()} }; the whole "
              f"merge (ms, CUDA events, best of 4 in turns) "
              f"{ {g: round(min(t), 4) for g, t in merged.items()} }",
              flush=True)

    from torch.profiler import ProfilerActivity, profile

    for what, (a, av, b, bv) in shapes.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                merge.merge_sorted(a, av, b, bv)
            torch.cuda.synchronize()
        print(f"torch.profiler, 10 calls at {what}:", flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6,
                                        max_name_column_width=50), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
