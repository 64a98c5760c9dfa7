"""The (data, model) mesh of the port, over ``torch.distributed``.

Counterpart of the JAX package's ``launch/mesh.py``. A :class:`Mesh` lays
given ranks of the initialized default process group out as an (n_data,
n_model) grid, data-major: the rank at ``grid[d][m]`` sits at data = d,
model = m. Queries split over ``data``; corpus rows and, where it divides,
the vocabulary over ``model``. The engines take the mesh as an explicit
argument and never read an ambient one.

A mesh is made in two steps. :func:`plan_mesh` lays it out: a plan holds
the grid and no process group, so one rank can make it and hand it on
(``EmdServer.reshard`` broadcasts a plan to its followers).
:func:`join_mesh` then creates its groups, one for each row (``model``)
and each column (``data``) of the grid that has more than one rank. That
is a collective over the default group: every rank of the world calls it
with the same plan, and a rank outside the grid gets None. The grid may
be any subset of the world (a server resharded onto half the machine, the
other half idle) or all of it (:func:`make_test_mesh`).

Every collective of a mesh waits at most ``timeout`` seconds: its groups
are created with that limit (torch's default for a new group is the
backend's, 30 minutes on gloo), so a rank that fails in the middle of a
step leaves the others waiting that long and no longer.

The backend (``gloo`` or ``nccl``) is an argument, checked against the
default group's; nothing picks one by trying. A 1 x 1 mesh made with no
process group initialized holds no group at all: every collective over a
one-rank axis is the identity and moves nothing, so it needs none, and the
process's ``torch.distributed`` state is left as it was. ``device`` is
where the rank's tensors live: the CPU, or a CUDA device (several gloo
ranks may share one card; NCCL takes one rank a card).

The LM train, prefill and decode steps run on such a mesh too
(``launch/steps.py`` ``make_mesh_train_step``, ``make_mesh_prefill_step``,
``make_mesh_decode_step``, laid out by ``sharding/rules.py``).
``make_production_mesh`` (the TPU pod shapes, with a ``pod`` axis this
``Mesh`` lacks) is not ported yet (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

#: The mesh's dimension names, outermost first.
AXES = ("data", "model")

#: The collective backends a mesh can run on.
MESH_BACKENDS = ("gloo", "nccl")

#: Seconds a mesh's collective may wait by default.
DEFAULT_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a (data, model) mesh, or a plan of one.

    ``grid``: the world ranks, ``grid[d][m]`` at data d, model m (None for
    a one-rank mesh with no process group); ``backend``: the collective
    backend; ``device``: the rank's device (a plan's may lack the CUDA
    index, which :func:`join_mesh` picks); ``timeout``: seconds a
    collective may wait. ``coords`` and ``groups`` are this rank's
    coordinates and the process group of each axis longer than one rank;
    a plan has neither."""
    grid: tuple[tuple[int, ...], ...] | None
    backend: str
    device: torch.device
    timeout: float = DEFAULT_TIMEOUT
    coords: dict | None = None
    groups: dict | None = None

    @property
    def joined(self) -> bool:
        """False for a plan, whose groups are not created yet."""
        return self.grid is None or self.coords is not None

    @property
    def shape(self) -> dict[str, int]:
        if self.grid is None:
            return dict.fromkeys(AXES, 1)
        return dict(zip(AXES, (len(self.grid), len(self.grid[0]))))

    @property
    def axis_names(self) -> tuple[str, ...]:
        """The axes, outermost first (the sharding rules read them)."""
        return AXES

    @property
    def ranks(self) -> tuple[int, ...]:
        """The world ranks of the grid, data-major (``(0,)`` for a mesh
        with no process group)."""
        if self.grid is None:
            return (0,)
        return tuple(r for row in self.grid for r in row)

    @property
    def leader(self) -> int:
        """The world rank at data 0, model 0."""
        return self.ranks[0]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def _check_joined(self) -> None:
        if not self.joined:
            raise ValueError(f"{self!r} is a plan: join_mesh creates its "
                             "groups")

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self._check_joined()
        return 0 if self.grid is None else self.coords[axis]

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinate (the ranks a collective over ``axis`` joins)."""
        self._check_joined()
        if self.size(axis) == 1:
            raise ValueError(f"the {axis!r} axis has one rank and no "
                             "process group: a collective over it moves "
                             "nothing")
        return self.groups[axis]

    def __repr__(self) -> str:
        where = "" if self.joined else ", plan"
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device}{where})")


def _rank_device(device) -> torch.device:
    device = torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} was given device {device} and "
                               "finds no CUDA device")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported mesh device {device}; cpu or cuda")
    return device


def _check_dims(n_data: int, n_model: int, backend: str, device) -> None:
    if backend not in MESH_BACKENDS:
        raise ValueError(f"unknown mesh backend {backend!r}; one of "
                         f"{MESH_BACKENDS}")
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh dims must be >= 1, got ({n_data}, "
                         f"{n_model})")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got "
                         f"{device!r}")


def plan_mesh(n_data: int, n_model: int, *, ranks=None,
              backend: str = "gloo", device="cpu",
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """The plan of an (n_data, n_model) mesh over ``ranks`` of the
    default group, data-major (default: ranks 0 .. n_data * n_model - 1).
    It creates nothing: :func:`join_mesh` does, on every rank."""
    _check_dims(n_data, n_model, backend, device)
    ranks = tuple(range(n_data * n_model)) if ranks is None else \
        tuple(int(r) for r in ranks)
    if len(ranks) != n_data * n_model or len(set(ranks)) != len(ranks) \
            or min(ranks) < 0:
        raise ValueError(f"a ({n_data}, {n_model}) mesh takes "
                         f"{n_data * n_model} distinct ranks, got {ranks}")
    if timeout <= 0:
        raise ValueError(f"timeout must be > 0 seconds, got {timeout}")
    grid = tuple(ranks[d * n_model:(d + 1) * n_model]
                 for d in range(n_data))
    return Mesh(grid=grid, backend=backend, device=torch.device(device),
                timeout=float(timeout))


def join_mesh(plan: Mesh) -> Mesh | None:
    """Create the groups of ``plan``: a collective over the default group,
    which every rank of the world calls with the same plan, in the same
    order as its other group creations. Returns this rank's mesh, or None
    on a rank outside the grid."""
    if not isinstance(plan, Mesh):
        raise ValueError(f"join_mesh takes a plan_mesh Mesh, got "
                         f"{type(plan).__name__}")
    if plan.joined:
        raise ValueError(f"{plan!r} is already joined")
    if not dist.is_initialized():
        raise ValueError(f"a mesh over ranks {plan.ranks} needs an "
                         "initialized process group")
    world = dist.get_world_size()
    if max(plan.ranks) >= world:
        raise ValueError(f"mesh ranks {plan.ranks} exceed the process "
                         f"group's {world}")
    if dist.get_backend() != plan.backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {plan.backend!r}")
    n_data, n_model = len(plan.grid), len(plan.grid[0])
    lines = {"model": list(plan.grid),
             "data": [tuple(row[m] for row in plan.grid)
                      for m in range(n_model)]}
    timeout = datetime.timedelta(seconds=plan.timeout)
    rank = dist.get_rank()
    groups = {}
    for axis in AXES:
        if len(lines[axis][0]) == 1:
            continue
        for line in lines[axis]:
            g = dist.new_group(list(line), timeout=timeout,
                               backend=plan.backend)
            if rank in line:
                groups[axis] = g
    where = [(d, m) for d in range(n_data) for m in range(n_model)
             if plan.grid[d][m] == rank]
    if not where:
        return None
    (d, m), = where
    return dataclasses.replace(plan, device=_rank_device(plan.device),
                               coords={"data": d, "model": m},
                               groups=groups)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   backend: str = "gloo", device="cpu",
                   timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A (n_data, n_model) mesh over the whole initialized default process
    group, which must have n_data * n_model ranks and run ``backend``
    (``repro_torch.launch.local`` starts such ranks on one host). With no
    group initialized a 1 x 1 mesh is one rank with no group (module
    docstring): the single-device default of ``EmdIndex``, which leaves
    the process free to build another on any device.

    ``device`` "cuda" without an index puts rank r on card r % the cards
    visible; NCCL needs CUDA tensors, gloo takes either."""
    _check_dims(n_data, n_model, backend, device)
    world = n_data * n_model
    if not dist.is_initialized():
        if world != 1:
            raise ValueError(
                f"a ({n_data}, {n_model}) mesh needs an initialized process "
                f"group of {world} ranks (repro_torch.launch.local.run_local "
                "starts them)")
        return Mesh(grid=None, backend=backend, device=_rank_device(device),
                    timeout=float(timeout))
    if dist.get_world_size() != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {world} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return join_mesh(plan_mesh(n_data, n_model, backend=backend,
                               device=device, timeout=timeout))


def world_group(timeout: float):
    """A new gloo group over every rank of the default group, each wait
    limited to ``timeout`` seconds: the host channel beside a mesh (a
    server's commands, a reshard's rows), whatever the mesh's backend. A
    collective over the default group; None in a world of one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout))


def model_axis_size(mesh: Mesh) -> int:
    """The ``model`` size: how many ways the rows (and, where it divides,
    the vocabulary) split. The queries split over ``data`` alone (JAX's
    ``data_axes``: the port has no ``pod`` axis)."""
    return mesh.size("model")
