"""Many processes, one device each (port of
``srtb_tpu/parallel/distributed.py``).

The reference joins a ``jax.distributed`` process group (one process a
host) and lays the embarrassingly parallel ``dm`` axis across slices
(DCN) and the communication-heavy ``seq`` axis inside a slice (ICI).  The
port runs one process a device on ``torch.distributed``: NCCL for a CUDA
device, gloo for the CPU, chosen once and never swapped for the other
when it fails.  A "slice" is a host: the ranks of one node, which
torchrun numbers contiguously (``LOCAL_WORLD_SIZE`` ranks a node, the
node's ``GROUP_RANK``), so :func:`hybrid_dm_seq_mesh` keeps each ``seq``
row on one host and lays ``dm`` across hosts.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from srtb_tpu_torch.parallel import mesh as M
from srtb_tpu_torch.utils.device import resolve_device
from srtb_tpu_torch.utils.logging import log

# how long a rank waits for the others (the rendezvous, then each
# collective) before it fails instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids=None, device=None,
               timeout_s: float | None = None) -> torch.device:
    """Join (or create) the process group: ``num_processes`` ranks meet
    at ``coordinator_address`` (``host:port`` or a ``file://`` URL), this
    process is rank ``process_id``.  On the card (``device`` None or a
    CUDA device) the backend is NCCL and the rank's device is
    ``cuda:<local id>`` (``local_device_ids[0]``, else torchrun's
    ``LOCAL_RANK``, else the rank modulo the local device count); on the
    CPU it is gloo.  A group that fails to form raises; a rank missing
    past ``timeout_s`` (default ``DEFAULT_TIMEOUT_S``) fails its peers.
    Returns the rank's device."""
    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    kwargs = {}
    if dev.type == "cuda":
        backend = "nccl"
        if local_device_ids:
            local = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = process_id % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # the communicator binds to the rank's device at once
        kwargs["device_id"] = dev
    else:
        backend = "gloo"
    # ``host:port`` is a TCP rendezvous; a URL (``file://``) is as it is
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=url,
        world_size=num_processes, rank=process_id, timeout=timeout,
        **kwargs)
    log.info(f"[distributed] process {process_id}/{num_processes} joined "
             f"via {coordinator_address}: {backend}, device {dev}, "
             f"{dist.get_world_size()} global / 1 local devices")
    return dev


def maybe_initialize_from_config(cfg, device=None) -> bool:
    """Initialize the process group if the config asks for it.  Returns
    True when running multi-process."""
    if cfg.distributed_num_processes <= 1:
        return False
    if not cfg.distributed_coordinator:
        raise ValueError("distributed_num_processes > 1 needs "
                         "distributed_coordinator host:port")
    initialize(cfg.distributed_coordinator, cfg.distributed_num_processes,
               cfg.distributed_process_id, device=device)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if M.initialized():
        dist.destroy_process_group()


def rank_slices(local_world_size: int | None = None) -> list[int]:
    """The slice (host) of every rank of the default group: given
    ``local_world_size`` ranks a host, rank r is on host r //
    local_world_size; else each rank's torchrun ``GROUP_RANK`` (gathered
    from every rank); else ``LOCAL_WORLD_SIZE``; else one host."""
    world = M.world_size()
    if local_world_size is None and "GROUP_RANK" in os.environ \
            and M.initialized():
        mine = int(os.environ["GROUP_RANK"])
        out = [None] * world
        dist.all_gather_object(out, mine)
        return [int(s) for s in out]
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return [r // local_world_size for r in range(world)]


def hybrid_layout(slices: list[int], n_seq: int | None = None
                  ) -> np.ndarray:
    """The ranks of a ("dm", "seq") mesh with ``dm`` across slices and
    ``seq`` contiguous within one: ``slices[r]`` is rank r's slice.
    ``n_seq`` defaults to the ranks a slice (pure DM parallelism across
    slices); it must divide every slice's ranks."""
    by_slice: dict[int, list[int]] = {}
    for r, s in enumerate(slices):
        by_slice.setdefault(s, []).append(r)
    counts = {len(v) for v in by_slice.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven slices: { {k: len(v) for k, v in by_slice.items()} }")
    per_slice = counts.pop()
    if n_seq is None:
        n_seq = per_slice
    if per_slice % n_seq:
        raise ValueError(f"n_seq={n_seq} does not divide the "
                         f"{per_slice} devices per slice")
    # rows = dm shards: (slice, block within it); columns = seq shards.
    # Within a row every seq neighbour shares a slice, so the seq
    # collectives never leave the host
    rows = []
    for k in sorted(by_slice):
        ranks = by_slice[k]
        for b in range(per_slice // n_seq):
            rows.append(ranks[b * n_seq:(b + 1) * n_seq])
    return np.asarray(rows)


def hybrid_dm_seq_mesh(n_seq: int | None = None,
                       local_world_size: int | None = None) -> M.Mesh:
    """("dm", "seq") mesh with dm laid across hosts and seq within a host
    (:func:`hybrid_layout` of :func:`rank_slices`)."""
    slices = rank_slices(local_world_size)
    mesh = M.Mesh(hybrid_layout(slices, n_seq), ("dm", "seq"))
    log.debug(f"[distributed] hybrid mesh dm={mesh.shape['dm']} "
              f"seq={mesh.shape['seq']} over {len(set(slices))} slice(s)")
    return mesh


def process_local_dm_indices(mesh: M.Mesh, n_trials: int) -> list[int]:
    """Which DM-trial indices have a shard on this process — lets each
    host report/write only its own trials' results.  Contiguous blocks
    of ``n_trials // n_dm`` trials a dm row, as the trials are sharded."""
    n_dm = mesh.devices.shape[0]
    if n_trials % n_dm:
        raise ValueError(f"n_trials={n_trials} must divide by dm={n_dm}")
    per_row = n_trials // n_dm
    local = set()
    me = M.rank()
    for i, row in enumerate(mesh.devices):
        if me in np.asarray(row).reshape(-1).tolist():
            local.update(range(i * per_row, (i + 1) * per_row))
    return sorted(local)
