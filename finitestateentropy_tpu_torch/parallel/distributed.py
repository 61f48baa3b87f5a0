"""Multi-host setup.

The port of the JAX package's parallel/distributed.py: a process group
across hosts (``torch.distributed``: NCCL when CUDA is present, gloo
otherwise), a 2-level (dcn, ici) mesh across hosts or a flat one on a
single host, and the contiguous group ranges each process codes, the unit
of per-host retry.  Within a host one process drives every device of its
mesh row, as the JAX mesh is single-controller; a step over the (dcn,
ici) mesh runs each row on its own process and joins the rows over the
process group.  Pass the mesh itself to the entry points (``mesh=``): an
integer width counts this host's devices only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import device_count, make_mesh, make_mesh_2level


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join the job's process group: TCP init from coordinator_address
    ("host:port") with num_processes and process_id, or ``env://``
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) when the arguments are
    omitted."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def codec_mesh(device=None):
    """Mesh for this job: (dcn, ici) across hosts, or flat dp on one host
    (device: as make_mesh)."""
    n_local = device_count(device)
    n_proc = _process_count()
    if n_proc > 1:
        return make_mesh_2level(n_proc, n_local, device)
    return make_mesh(n_local, device=device)


def shard_ranges(n_groups: int, mesh=None) -> list[tuple[int, int]]:
    """Contiguous group ranges per process, the unit of per-host retry."""
    n_proc = _process_count()
    per = (n_groups + n_proc - 1) // n_proc
    return [(i * per, min((i + 1) * per, n_groups)) for i in range(n_proc)]
