"""The device mesh (port of ``srtb_tpu/parallel/mesh.py``).

The scaling axes of the search:
- ``dm``: independent DM trials (each rank of the axis takes a block of
  the trials and the same cleaned spectrum);
- ``seq``: one segment's samples and channels sharded over the ranks
  (the distributed four-step FFT's all-to-all transposes, sums for the
  global statistics).

One process drives one device (NCCL on the card, gloo on the CPU), so a
mesh is a layout of the ranks of the default process group: ``devices``
holds the global ranks, ``[n_dm, n_seq]`` for a ("dm", "seq") mesh.
Each axis has a process group for each of its lines (the ranks of a row
for ``seq``, of a column for ``dm``), made once by every rank in the same
order, as ``torch.distributed.new_group`` requires.  The collectives the
sharded step makes over an axis are the mesh's methods, each counted in
``inventory`` under the reference's primitive names (``all_to_all``,
``ppermute``, ``psum``), so that its collective inventory can be held to
the reference's.  With no process group the mesh is (1, 1) and its
collectives are identities; a group of one rank (world size 1) runs its
collectives on that group.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def _line_group(ranks: list[int]):
    """The process group of ``ranks`` (sorted): the default group when
    they are the whole world, else a new group.  Every rank calls this
    for every line, in the same order."""
    if ranks == list(range(world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks=ranks)


class Mesh:
    """Global ranks laid out over named axes (module docstring)."""

    def __init__(self, devices, axis_names=("dm", "seq")):
        devices = np.asarray(devices, dtype=np.int64)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of axes {axis_names} needs a "
                             f"{len(axis_names)}-D rank layout, got "
                             f"{devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.inventory: Counter = Counter()
        if not initialized() and devices.size > 1:
            raise ValueError(f"a mesh of {devices.size} devices needs a "
                             "process group (distributed.initialize)")
        here = np.argwhere(devices == rank())
        # this rank's coordinates (None: the rank is outside the mesh)
        self.coords = (None if not here.size else
                       dict(zip(self.axis_names, map(int, here[0]))))
        self._groups: dict = {}
        if not initialized():
            return
        for k, name in enumerate(self.axis_names):
            lines = np.moveaxis(devices, k, -1).reshape(-1, devices.shape[k])
            for line in lines.tolist():
                if line != sorted(line):
                    # a group's ranks are its members in sorted order,
                    # and the collectives index the axis by them
                    raise ValueError(f"the ranks of a {name!r} line must "
                                     f"increase along it, got {line}")
                group = _line_group(line)
                if rank() in line:
                    self._groups[name] = group

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks {self.devices.tolist()}, "
                f"coords {self.coords})")

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def _count(self, name: str, axis: str) -> None:
        self.inventory[(name, (axis,))] += 1

    def _group(self, axis: str):
        return self._groups.get(axis) if initialized() else None

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [n, ...]``, chunk j sent to index j along ``axis``; returns
        ``[n, ...]``, chunk i received from index i (the reference's
        untiled ``all_to_all``)."""
        self._count("all_to_all", axis)
        if self._group(axis) is None:
            return x
        src = _real(x.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._group(axis))
        return _like(out, x)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``."""
        self._count("psum", axis)
        if self._group(axis) is None:
            return x
        out = _real(x.contiguous()).clone()
        dist.all_reduce(out, group=self._group(axis))
        return _like(out, x)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``x`` sent along ``axis`` by ``perm`` [(source, destination)],
        every index a source once (the reference's ``ppermute``): one
        all-to-all whose chunks are empty but the one to the destination
        and the one from the source."""
        self._count("ppermute", axis)
        group = self._group(axis)
        if group is None:
            return x
        me = self.index(axis)
        dst = dict(perm)[me]
        src = {d: s for s, d in perm}[me]
        flat = _real(x.contiguous()).reshape(-1)
        n = self.shape[axis]
        out = torch.empty_like(flat)
        dist.all_to_all_single(
            out, flat,
            output_split_sizes=[flat.numel() if i == src else 0
                                for i in range(n)],
            input_split_sizes=[flat.numel() if i == dst else 0
                               for i in range(n)],
            group=group)
        return _like(out.reshape(_real(x).shape), x)


def _real(x: torch.Tensor) -> torch.Tensor:
    """Complex tensors travel as their float view (both backends take
    float32; the sums are the same)."""
    return torch.view_as_real(x) if x.is_complex() else x


def _like(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(out) if x.is_complex() else out


def make_mesh(n_dm: int = 1, n_seq: int = 1, devices=None) -> Mesh:
    """A ("dm", "seq") mesh.  n_dm * n_seq must divide the available device
    count (the ranks of the default group, or ``devices``); by default
    all devices go to the dm axis."""
    if devices is None:
        devices = list(range(world_size()))
    n = len(devices)
    if n_dm * n_seq == 1:
        n_dm = n
    if n % (n_dm * n_seq):
        raise ValueError(
            f"{n} devices not divisible into dm={n_dm} x seq={n_seq}")
    use = np.asarray(devices[: n_dm * n_seq]).reshape(n_dm, n_seq)
    return Mesh(use, ("dm", "seq"))


def seq_mesh(n_seq: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = list(range(world_size()))
    if n_seq is None:
        n_seq = len(devices)
    return Mesh(np.asarray(devices[:n_seq]), ("seq",))


def dm_mesh(n_dm: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = list(range(world_size()))
    if n_dm is None:
        n_dm = len(devices)
    return Mesh(np.asarray(devices[:n_dm]), ("dm",))
