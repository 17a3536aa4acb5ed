"""Several processes, one or more hosts (``gossamer_tpu/parallel/distributed.py``).

The reference's multi-machine story is "build shards on separate machines,
then merge-graphs" (``docs/goss.md:52-55,388``).  Here every process runs
the same program over ``torch.distributed``, reads its share of the input
files, and the sharded count (:mod:`.count_sharded`) exchanges k-mers with
the same all-to-all, with the key partition spanning every process's
shards.

Usage (one process per host):

    from gossamer_tpu_torch.parallel import distributed
    distributed.initialize(coordinator="host0:9981", num_processes=N,
                           process_id=i, device="cuda")
    mesh = distributed.global_mesh("cuda")
    ... ShardedSpectrumEngine(mesh, ...) fed with this host's chunks

The process group's backend follows the device: ``nccl`` for ``cuda``,
``gloo`` for ``cpu``.  Processes may stream different numbers of chunks:
the sharded engines keep every process in each exchange until all have
finished.  Every process ends with the whole result.
"""

from __future__ import annotations

import torch


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """``torch.distributed.init_process_group`` at ``tcp://coordinator``
    (``host:port``; process 0 listens there).  ``device`` picks the
    backend; a ``cuda`` device without a card raises before any group
    starts (the CPU's gloo group only when asked for)."""
    import torch.distributed as dist

    if not coordinator or not num_processes:
        raise ValueError("several processes need a coordinator address and "
                         "their number")
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"distributed.initialize: device {device!r} needs "
                           "CUDA and torch.cuda.is_available() is false; pass "
                           "device='cpu' for a gloo group")
    backend = "nccl" if cuda else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes of the group (1 without :func:`initialize`)."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def local_device_count(device) -> int:
    """Shards a process holds by default: every visible card for ``cuda``,
    one for ``cpu``."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def global_mesh(device, n_local: int | None = None):
    """A mesh over every process's shards: ``n_local`` each (default
    :func:`local_device_count`)."""
    from .mesh import data_mesh

    n_local = n_local or local_device_count(device)
    return data_mesh(process_count() * n_local, device)


def partition_files(paths: list[str], process_id: int, num_processes: int) -> list[str]:
    """Static round-robin file assignment per process."""
    return [p for i, p in enumerate(paths) if i % num_processes == process_id]


def configure(opts, files: list, device, log=None):
    """CLI hook (build-graph/build-kmer-set ``--coordinator`` etc.):
    initialize the process group, take this process's file share, and
    return (files_for_this_process, global shard count); ``(files, None)``
    without a coordinator."""
    coord = getattr(opts, "coordinator", None)
    if not coord:
        return files, None
    num = int(getattr(opts, "num_processes", 0) or 0)
    pid = int(getattr(opts, "process_id", 0) or 0)
    initialize(coordinator=coord, num_processes=num, process_id=pid,
               device=device)
    n_global = num * local_device_count(device)
    mine = set(partition_files([n for n, _ in files], pid, num))
    if log is not None:
        log("info", f"distributed: process {pid}/{num} takes {len(mine)}/"
                    f"{len(files)} input files, {n_global} shards by default")
    return [f for f in files if f[0] in mine], n_global
