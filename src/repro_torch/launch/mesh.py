"""Device meshes over ``torch.distributed`` processes.

The port of ``repro.launch.mesh``. A JAX mesh is a grid of devices that one
program drives; here it is a grid of processes, one rank per mesh point, in
row-major order over the axes (rank = sum of coordinate times stride, the
last axis fastest). Each rank sees the mesh's axis names and shape, its own
coordinates, and one process group per axis: the ranks that share every
other coordinate (``Mesh.group(axis)``). The collectives of
``distributed/collectives.py`` run over those groups, each wait bounded by
the mesh's ``timeout_s`` (a rank that died or hung fails its peers).

Axis roles (as in JAX):
  pod   - data parallelism across pods / independent service areas;
  data  - batch (requests) and, in train mode, FSDP weight sharding;
  model - tensor and expert parallelism, and the sequence shards of a
          cache whose KV heads do not divide it.

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group (its rank grid is row-major, as here), whose groups
take the default group's backend, gloo: NCCL refuses two ranks on one
device, and a card tool that hands out one H100 runs a mesh as several
processes on it (on an H100, four ranks on one card built their gloo
sub-groups this way and reduced CUDA tensors over them). Gloo reduces CUDA
tensors only by ``all_reduce`` (not ``all_gather`` or ``reduce_scatter``),
which is why every collective of the port is an ``all_reduce``.

A mesh can also be built from a bare shape (``Mesh.from_shape``), with no
rank and no groups, so that the sharding policy's rules can be checked at
production shapes (16 x 16, 2 x 16 x 16) on one CPU.

Nothing here runs at import time, and nothing starts processes: the caller
initialises the default process group (``init_process_group``) in each of
its ranks, then builds the mesh in every one of them.
"""
from __future__ import annotations

import datetime
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import resolve_device

# the seconds a collective may wait for its peers before it fails (a rank
# that died or hung must not hold the others forever)
COLLECTIVE_TIMEOUT_S = 120.0


class Mesh:
    """Axis names, shape, this rank's coordinates and one process group per
    axis (or a bare shape: ``rank`` None, no groups)."""

    def __init__(self, shape: Dict[str, int], *, rank: Optional[int] = None,
                 device_mesh=None, device=None):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = dict(shape)
        self.size = math.prod(shape.values())
        self.rank = rank
        self.device = device
        self.device_mesh = device_mesh
        self.coords: Dict[str, int] = {}
        if rank is not None:
            rem = rank
            for axis in reversed(self.axis_names):
                self.coords[axis] = rem % shape[axis]
                rem //= shape[axis]

    @classmethod
    def from_shape(cls, shape: Dict[str, int]) -> "Mesh":
        """A bare mesh of ``{axis: size}``: no rank, no groups."""
        return cls(shape)

    def group(self, axis: str):
        """The process group of the ranks that differ from this one in
        ``axis`` only."""
        if self.device_mesh is None:
            raise ValueError(f"a bare mesh (shape {self.shape}) has no process groups")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def init_process_group(rank: int, world_size: int, address: str, *,
                       timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """The default gloo process group of one rank: ``address`` is
    ``tcp://host:port`` (a free port on the machine), every collective's
    wait bounded by ``timeout_s``."""
    dist.init_process_group("gloo", init_method=address, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _make_mesh(shape: Dict[str, int], device, timeout_s: float) -> Mesh:
    """The mesh over the default process group's ranks (every rank calls
    this, in one order with its other collectives)."""
    from torch.distributed.device_mesh import init_device_mesh

    resolve_device(device)  # no card and no device="cpu": raise before anything else
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(launch.mesh.init_process_group in every rank)")
    need = math.prod(shape.values())
    if dist.get_world_size() != need:
        raise RuntimeError(f"a mesh of shape {shape} needs {need} ranks; the process group "
                           f"has {dist.get_world_size()}")
    rank = dist.get_rank()
    dev = _rank_device(device, rank)
    dm = init_device_mesh(dev.type, tuple(shape.values()), mesh_dim_names=tuple(shape))
    set_timeout = getattr(dist.distributed_c10d, "_set_pg_timeout", None)
    for axis in shape:
        if set_timeout is not None:  # the groups' default wait is 30 minutes
            set_timeout(datetime.timedelta(seconds=timeout_s), dm.get_group(axis))
    mesh = Mesh(shape, rank=rank, device_mesh=dm, device=dev)
    if [mesh.coords[a] for a in shape] != list(dm.get_coordinate()):
        raise RuntimeError(f"rank {rank}: DeviceMesh coordinates {dm.get_coordinate()} are not "
                           f"the row-major {mesh.coords}")
    return mesh


def _rank_device(device, rank: int) -> torch.device:
    """The device of a rank's tensors: the CPU, or card ``rank % cards``
    (all ranks share one card on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model): 256 or 512
    ranks, as the JAX mesh needs 256 or 512 devices."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return _make_mesh(shape, device, timeout_s)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, multi_pod: bool = False,
                    device="cuda", timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """A small mesh for tests and the card (n_data x n_model ranks, twice
    that with the pod axis)."""
    if multi_pod:
        return _make_mesh({"pod": 2, "data": n_data, "model": n_model}, device, timeout_s)
    return _make_mesh({"data": n_data, "model": n_model}, device, timeout_s)


def batch_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh) -> str:
    return "model"
