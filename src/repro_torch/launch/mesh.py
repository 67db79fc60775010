"""Device meshes over ``torch.distributed`` ranks (port of
:mod:`repro.launch.mesh`).

A :class:`Mesh` names the axes of a grid of ranks, row-major: in a
``("data", "model")`` mesh of shape ``(d, m)`` rank ``r`` sits at
``(r // m, r % m)``.  Sharding specs need only its ``shape`` and
``axis_names``, so :func:`make_production_mesh` and :func:`make_test_mesh`
return abstract meshes with no process group.  :func:`init_mesh` builds
the live mesh of a world that exists: one process group for every set of
axes (the ranks that differ only along them), created in the same order
on every rank.

Topology contract (the reference's):
    single pod : (16, 16)    axes ("data", "model")
    multi-pod  : (2, 16, 16) axes ("pod", "data", "model"); only the
                 gradient all-reduce crosses pods.

:func:`loopback_mesh` is a live mesh of one process with no process
group: one rank of a mesh of any size, whose collectives give their
results' shapes (:mod:`repro_torch.models.sharding`); the dry run traces
rank 0 of :func:`make_production_mesh` on it.

:func:`spawn` runs a function on every rank of a new world on this host:
NCCL with one rank per card where there are enough cards, gloo otherwise
(the CPU, or ranks sharing cards; the collectives then stage CUDA tensors
through host memory, :mod:`repro_torch.models.sharding`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import socket
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group of one set of mesh axes as seen from one rank:
    its ``size`` and this rank's ``index`` in it (row-major over the
    axes, in mesh order)."""
    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    #: live meshes only: this process's global rank, device, backend and
    #: the group of each set of axes (a tuple in mesh order)
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    groups: Dict[Tuple[str, ...], AxisGroup] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if len(self.devices_shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.devices_shape} and axes "
                             f"{self.axis_names} differ in length")
        if any(n < 1 for n in self.devices_shape):
            raise ValueError(f"mesh shape {self.devices_shape}: every axis "
                             f"needs at least one rank")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        return math.prod(self.devices_shape)

    @property
    def live(self) -> bool:
        return self.rank is not None

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The coordinates of ``rank`` (default: this process's)."""
        r = self.rank if rank is None else rank
        out = {}
        for name, n in reversed(list(zip(self.axis_names,
                                          self.devices_shape))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def ordered(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or names) in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in the mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes) -> AxisGroup:
        """The group of ``axes`` that holds this rank."""
        if not self.live:
            raise RuntimeError("an abstract mesh has no process groups; "
                               "build a live one with init_mesh")
        return self.groups[self.ordered(axes)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    return Mesh((data, model), ("data", "model"))


def init_mesh(shape: Sequence[int], names: Sequence[str],
              device=None) -> Mesh:
    """The live mesh of the initialized world (its size must be the
    mesh's), on ``device`` (default: this rank's card, or the CPU under a
    CPU world).  Every rank calls it, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialized process group "
                           "(spawn, or torchrun)")
    shape, names = tuple(int(n) for n in shape), tuple(names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    dev = torch.device(device) if device is not None else default_device()
    abstract = Mesh(shape, names)
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            groups[axes] = _axis_group(abstract, axes, rank)
    return Mesh(shape, names, rank=rank, device=dev,
                backend=dist.get_backend(), groups=groups)


def loopback_mesh(shape: Sequence[int], names: Sequence[str], rank: int = 0,
                  device="cpu") -> Mesh:
    """Rank ``rank`` of a mesh of ``shape`` in this process alone: its
    groups hold no process group, only their sizes and this rank's index
    in each (cheap at any size), and its backend is ``"loopback"``."""
    abstract = Mesh(tuple(int(n) for n in shape), tuple(names))
    c = abstract.coords(rank)
    groups = {}
    for k in range(1, len(abstract.axis_names) + 1):
        for axes in itertools.combinations(abstract.axis_names, k):
            size, index = 1, 0
            for a in axes:
                size *= abstract.shape[a]
                index = index * abstract.shape[a] + c[a]
            groups[axes] = AxisGroup(None, size, index)
    return Mesh(abstract.devices_shape, abstract.axis_names, rank=rank,
                device=torch.device(device), backend="loopback",
                groups=groups)


def _axis_group(mesh: Mesh, axes: Tuple[str, ...], rank: int) -> AxisGroup:
    """Create every group of ``axes`` (all ranks take part in each
    creation) and keep this rank's."""
    others = [a for a in mesh.axis_names if a not in axes]
    mine = None
    sizes = mesh.shape
    for fixed in itertools.product(*[range(sizes[a]) for a in others]):
        members = []
        for r in range(mesh.size):
            c = mesh.coords(r)
            if all(c[a] == v for a, v in zip(others, fixed)):
                members.append(r)
        pg = dist.group.WORLD if len(members) == mesh.size else \
            dist.new_group(members)
        if rank in members:
            mine = AxisGroup(pg, len(members), members.index(rank))
    return mine


#: the device type of this process's world (set by :func:`init_world`)
_WORLD = {"device": "cpu"}


def default_device() -> torch.device:
    """This rank's device in an initialized world: its card (``rank %
    cards``, set by :func:`init_world`) in a world on the cards, else the
    CPU."""
    if _WORLD["device"] == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def backend_for(device: str, world: int) -> str:
    """NCCL with a card for every rank, gloo otherwise."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, port: Optional[int],
               device: str) -> str:
    """Join a world of ``world`` ranks at ``tcp://localhost:port`` (``port``
    None: the ``MASTER_ADDR`` / ``MASTER_PORT`` that ``torchrun`` sets);
    returns the backend.  Under ``device="cuda"`` rank ``r`` takes card
    ``r % cards``."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the mesh on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    _WORLD["device"] = device
    backend = backend_for(device, world)
    dist.init_process_group(
        backend, init_method="env://" if port is None
        else f"tcp://localhost:{port}", rank=rank, world_size=world)
    return backend


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, port: int, device: str,
           args: tuple) -> None:
    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_world(rank, world, port, device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          device: str = "cpu") -> None:
    """``fn(rank, world, *args)`` on ``world`` new processes joined in one
    process group; raises if a rank fails.  ``fn`` must be importable
    (a module-level function)."""
    import torch.multiprocessing as mp
    mp.start_processes(_entry, args=(fn, world, free_port(), device, args),
                       nprocs=world, start_method="spawn", join=True)
