"""The (data, model) mesh of the port, over ``torch.distributed``.

Counterpart of the JAX package's ``launch/mesh.py``. A :class:`Mesh` wraps
a ``DeviceMesh`` with the dimension names ``("data", "model")`` built over
the initialized default process group: rank r sits at data = r // n_model,
model = r % n_model. Queries split over ``data``; corpus rows and, where it
divides, the vocabulary over ``model``. The engines take the mesh as an
explicit argument and never read an ambient one.

The backend (``gloo`` or ``nccl``) is an argument, checked against the
default group's; nothing picks one by trying. A 1 x 1 mesh built with no
process group initialized holds no group at all: every collective over a
one-rank axis is the identity and moves nothing, so it needs none, and
the process's ``torch.distributed`` state is left as it was. ``device`` is where the
rank's tensors live: the CPU, or a CUDA device (several gloo ranks may
share one card; NCCL takes one rank a card).

``make_production_mesh`` (the TPU pod shapes) waits for the LM stack.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

#: The mesh's dimension names, outermost first.
AXES = ("data", "model")

#: The collective backends a mesh can run on.
MESH_BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a (data, model) mesh: the ``DeviceMesh`` (None
    for a one-rank mesh with no process group), the collective backend and
    the rank's device."""
    device_mesh: object
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        if self.device_mesh is None:
            return dict.fromkeys(AXES, 1)
        return dict(zip(AXES, self.device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinate (the ranks a collective over ``axis`` joins)."""
        if self.device_mesh is None:
            raise ValueError("a one-rank mesh has no process group: a "
                             "collective over its axes moves nothing")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device})")


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


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   backend: str = "gloo", device="cpu") -> Mesh:
    """A (n_data, n_model) mesh over the initialized default process
    group, which must have n_data * n_model ranks and run ``backend``
    (``repro_torch.launch.local`` starts such ranks on one host). With no
    group initialized a 1 x 1 mesh is one rank with no group (module
    docstring): the single-device default of ``EmdIndex``, which leaves
    the process free to build another on any device.

    ``device`` "cuda" without an index puts rank r on card r % the cards
    visible; NCCL needs CUDA tensors, gloo takes either."""
    if backend not in MESH_BACKENDS:
        raise ValueError(f"unknown mesh backend {backend!r}; one of "
                         f"{MESH_BACKENDS}")
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh dims must be >= 1, got ({n_data}, "
                         f"{n_model})")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got "
                         f"{device!r}")
    world = n_data * n_model
    if not dist.is_initialized():
        if world != 1:
            raise ValueError(
                f"a ({n_data}, {n_model}) mesh needs an initialized process "
                f"group of {world} ranks (repro_torch.launch.local.run_local "
                "starts them)")
        return Mesh(device_mesh=None, backend=backend,
                    device=_rank_device(device))
    if dist.get_world_size() != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {world} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    device = _rank_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (n_data, n_model), mesh_dim_names=AXES)
    return Mesh(device_mesh=dm, backend=backend, device=device)


def model_axis_size(mesh: Mesh) -> int:
    """The ``model`` size: how many ways the rows (and, where it divides,
    the vocabulary) split. The queries split over ``data`` alone (JAX's
    ``data_axes``: the port has no ``pod`` axis)."""
    return mesh.size("model")
