"""Device meshes for the data-parallel codec.

The port of the JAX package's parallel/mesh.py.  The codec's only parallel
axis is data parallelism over independent groups; a mesh names the devices
that the group batches split over.  As in JAX, one process drives every
device of its mesh (there is no process group per device): a step moves
each shard to its device and launches that shard's kernels there.

A mesh's devices are the CUDA devices.  The CPU mesh, CPU_DEVICES entries
of ``torch.device("cpu")`` on which the wrappers run their plain versions,
is the counterpart of the 8 virtual CPU devices the JAX package's tests
get; a caller asks for it by name (``device="cpu"``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

CPU_DEVICES = 8


class Mesh:
    """An array of torch devices with one axis name per dimension, as
    jax.sharding.Mesh holds them (``mesh.devices.size`` is the device
    count)."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices, axes {self.axis_names}")

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def _devices(device=None) -> list[torch.device]:
    """The devices a mesh of kind `device` (None: cuda) may hold."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise ValueError(f"no mesh of {kind} devices: use cuda, or cpu for the tests")


def device_count(device=None) -> int:
    return len(_devices(device))


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device=None) -> Mesh:
    devs = _devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def make_mesh_2level(n_hosts: int, per_host: int, device=None) -> Mesh:
    """(dcn, ici) mesh for multi-host runs, one process per host.  JAX's
    global device list spans the hosts; a torch process reaches only its
    own host's devices, so row h names host h's devices by their local
    index.  A step over this mesh runs on each process the shards of the
    row of its rank and gathers the other rows' over the process group
    (parallel/turbo_dp.py)."""
    devs = _devices(device)[:per_host]
    if len(devs) < per_host:
        raise ValueError(f"{per_host} devices per host asked, {len(devs)} here")
    return Mesh([devs] * n_hosts, ("dcn", "ici"))


def get_mesh(n: int, device=None) -> Mesh | None:
    """Mesh for a user-requested data-parallel width, or None for 1-device.

    n <= 1 or fewer attached devices than requested -> None (callers fall
    back to the single-device path, matching the CLI --mesh contract)."""
    if n <= 1:
        return None
    avail = device_count(device)
    if avail < n:
        warnings.warn(f"--mesh {n} requested but only {avail} device(s) "
                      f"attached; running single-device")
        return None
    return make_mesh(n, device=device)
