"""Shards over devices and the collectives between them.

Counterpart of ``gossamer_tpu/parallel/mesh.py`` and of the ``jax.lax``
collectives that the JAX package's ``shard_map`` bodies use on axis
``"d"``.  A :class:`Mesh` is an ordered tuple of ``torch.device``s, one per
shard.  A sharded function runs its per-shard body (the counterpart of a
``shard_map`` body) once per shard, over that shard's tensors on that
shard's device, and the bodies meet only in the collectives below.  A
collective takes the list of this process's shards' tensors, in mesh order,
and returns one tensor per shard on the shard's device:

* within one process they are copies to each destination shard's device
  (peer copies between cards, nothing at all for shards that share one);
* across processes they go through the ``torch.distributed`` process group
  that :func:`..distributed.initialize` set up (``gloo`` for CPU tensors,
  ``nccl`` for CUDA tensors).  Each process holds an equal run of
  consecutive shards: its global shard indices are ``offset`` up.

Returned tensors may be shared between shards: callers do not write into
them.
"""

from __future__ import annotations

import torch


class Mesh:
    """Shards on axis ``"d"``: ``devices`` are this process's shards in
    order; ``size`` counts the shards of every process, and ``offset`` is
    the global index of this process's first shard."""

    def __init__(self, devices, *, size: int | None = None, offset: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.size = len(self.devices) if size is None else int(size)
        self.offset = int(offset)
        if (self.size % len(self.devices)
                or self.offset % len(self.devices)
                or not 0 <= self.offset <= self.size - len(self.devices)):
            raise ValueError(f"{len(self.devices)} local shards at offset "
                             f"{self.offset} do not tile a mesh of "
                             f"{self.size}")

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        """True when other processes hold some of the shards."""
        return self.n_local < self.size

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where results that
        every shard shares are assembled."""
        return self.devices[0]

    def local(self, rows):
        """This process's rows of a sequence over all shards."""
        return rows[self.offset : self.offset + self.n_local]

    def __repr__(self) -> str:
        where = ", ".join(str(d) for d in self.devices)
        return (f"Mesh({self.size} shards; this process: {where} from shard "
                f"{self.offset})")


def _dist():
    import torch.distributed as dist

    return dist


def _spread(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """One tensor -> a copy on each shard's device (no copy on its own)."""
    return [t.to(d) for d in mesh.devices]


def _gather_processes(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """(n_local, ...) of this process -> (size, ...) of every process."""
    dist = _dist()
    parts = [torch.empty_like(local) for _ in range(mesh.size // mesh.n_local)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def all_gather(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_gather(x, "d")``: each shard's tensor (all of one shape) ->
    on each shard the ``(size, *shape)`` stack of every shard's."""
    out = torch.stack([x.to(mesh.home) for x in xs])
    if mesh.distributed:
        out = _gather_processes(mesh, out)
    return _spread(mesh, out)


def psum(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.psum(x, "d")``: on each shard the sum over all shards."""
    total = xs[0].to(mesh.home).clone()
    for x in xs[1:]:
        total += x.to(mesh.home)
    if mesh.distributed:
        _dist().all_reduce(total)
    return _spread(mesh, total)


def pmax(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """The maximum over all shards, on this process's home device."""
    top = torch.stack([x.to(mesh.home) for x in xs]).amax(0)
    if mesh.distributed:
        dist = _dist()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return top


def all_to_all(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all(x, "d", split_axis=0, concat_axis=0, tiled=True)``
    over rows: shard s holds ``(size, ...)`` whose row d goes to shard d;
    shard d gets ``(size, ...)`` whose row s came from shard s."""
    if not mesh.distributed:
        return [torch.stack([x[d].to(dev) for x in xs])
                for d, dev in enumerate(mesh.devices)]
    # [dest shard][source local] laid out by destination process, so the
    # equal splits of all_to_all_single are the processes' shares
    send = torch.stack([x.to(mesh.home) for x in xs]).transpose(0, 1)
    send = send.contiguous()
    recv = torch.empty_like(send)
    _dist().all_to_all_single(recv, send)
    # recv: [source process][dest local][source local]
    nl = mesh.n_local
    recv = recv.view(mesh.size // nl, nl, nl, *send.shape[2:])
    return [recv[:, d].reshape(mesh.size, *send.shape[2:]).to(dev)
            for d, dev in enumerate(mesh.devices)]


def ppermute(mesh: Mesh, xs: list[torch.Tensor],
             perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """``lax.ppermute(x, "d", perm)``: shard ``dst`` gets what shard ``src``
    held, for each ``(src, dst)``; a shard that no pair names gets zeros."""
    every = (all_gather(mesh, xs)[0] if mesh.distributed
             else [x for x in xs])
    src_of = {dst: src for src, dst in perm}
    out = []
    for i, dev in enumerate(mesh.devices):
        g = mesh.offset + i
        out.append(every[src_of[g]].to(dev) if g in src_of
                   else torch.zeros_like(xs[i]))
    return out


def gather_rows(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard's 1-D tensor, of any length -> every shard's, in mesh
    order, on this process's home device (every process gets all)."""
    rows = [x.to(mesh.home) for x in xs]
    if not mesh.distributed:
        return rows
    lens = torch.tensor([r.numel() for r in rows], dtype=torch.int64,
                        device=mesh.home)
    lens = _gather_processes(mesh, lens.view(-1, 1)).view(-1).tolist()
    width = max(lens)
    padded = torch.zeros(mesh.n_local, width, dtype=rows[0].dtype,
                         device=mesh.home)
    for i, r in enumerate(rows):
        padded[i, : r.numel()] = r
    every = _gather_processes(mesh, padded)
    return [every[s, :n] for s, n in enumerate(lens)]


def put(mesh: Mesh, rows) -> list[torch.Tensor]:
    """Rows over all shards (a numpy array or a tensor of ``size`` rows) ->
    this process's rows, each on its shard's device."""
    if not isinstance(rows, torch.Tensor):
        import numpy as np

        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return [r.to(d) for r, d in zip(mesh.local(rows), mesh.devices)]


def data_mesh(n_devices: int, device) -> Mesh:
    """A mesh of ``n_devices`` shards (``data_mesh`` of the JAX package),
    spread evenly over the processes of :mod:`..distributed` when it is
    initialized.  For ``cuda`` this process's shards are ``cuda:0`` up, one
    card each, and it raises when fewer cards are visible: it never runs on
    a smaller mesh than asked for.  For ``cpu`` the shards all sit on the
    CPU (the counterpart of the JAX tests' virtual CPU devices)."""
    from .distributed import process_count, process_index

    device = torch.device(device)
    procs = process_count()
    if n_devices < 1 or n_devices % procs:
        raise ValueError(f"a mesh of {n_devices} shards does not split over "
                         f"{procs} processes")
    n_local = n_devices // procs
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < n_local:
            raise RuntimeError(
                f"several devices: a mesh of {n_devices} shards needs "
                f"{n_local} CUDA cards in this process, and {visible} are "
                f"visible")
        devices = [torch.device("cuda", i) for i in range(n_local)]
    elif device.type == "cpu":
        devices = [torch.device("cpu")] * n_local
    else:
        raise ValueError(f"no mesh on device {device}")
    return Mesh(devices, size=n_devices, offset=process_index() * n_local)
