"""The leader's channel to its followers: ``EmdServer`` on a mesh.

JAX drives every device of a mesh from one process. The port's mesh is a
world of processes, each running the same step, whose collectives every
rank must enter in the same order; an asyncio micro-batcher decides from
arrival times, so it cannot run on each rank alone. So one rank, the
mesh's (data 0, model 0), is the leader: it alone runs the queue, the
policy and the ladder, and it sends every rank of the world each command
that the ranks must run together (a launch, a mutation, a reshard, stop),
which the others, the followers, run in the order sent
(``EmdServer.follow``).

A command is a fixed header of :data:`HEADER` int64 (the op, the oldest
generation still in flight, then the op's fields), broadcast from the
leader, then its tensors, each broadcast in turn. Every command but stop
ends with a status exchange: each rank contributes 0 (done) or 1 (failed),
and every rank learns every rank's status, so no rank goes on alone after
another failed.

The channel is two gloo groups of the whole world
(``launch.mesh.world_group``) on host tensors, whatever the mesh's
backend: the headers are host data. A command's tensors and its status
exchange wait at most twice the mesh's timeout, so that a rank left
waiting in a mesh collective by a failed rank gives up first and then
reaches the status exchange. The header has a group of its own, whose
wait is :data:`IDLE_TIMEOUT`: a follower waits there for the leader's next
command however long the server stays idle, and a leader that exits ends
that wait at once (gloo raises on the closed connection). The bytes each
rank receives count in ``sharding.annotate.TRAFFIC`` under ``control``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import world_group
from repro_torch.sharding import annotate

#: Label of the channel's bytes in ``annotate.TRAFFIC``.
LABEL = "control"

#: int64 fields of a command's header.
HEADER = 8

#: The commands.
LAUNCH, APPEND, DELETE, RESHARD, STOP = 1, 2, 3, 4, 5

#: A rank's status after a command.
OK, FAILED = 0, 1

#: Seconds a follower waits for the leader's next command (a week: a
#: server may stay idle that long; a leader that exits ends the wait).
IDLE_TIMEOUT = 7 * 24 * 3600.0


class MeshFault(RuntimeError):
    """A command failed on a rank of the mesh (or on several): the ranks'
    collectives may be out of step, so the server treats it as a device
    fault (no retry, no cheaper tier)."""


@dataclasses.dataclass(frozen=True)
class Control:
    """The channel of one server's ranks: the world's gloo groups for the
    commands' headers (``head``) and the rest (``group``), the ``leader``'s
    world rank and this process's."""
    head: object
    group: object
    leader: int
    rank: int
    world: int

    @classmethod
    def create(cls, mesh) -> "Control | None":
        """A new channel for a server on ``mesh``, which must span the
        world (a collective over the default group: every rank calls it);
        None in a world of one rank or for a mesh with no process
        group."""
        if mesh.grid is None or not dist.is_initialized() \
                or dist.get_world_size() == 1:
            return None
        world = dist.get_world_size()
        if len(mesh.ranks) != world:
            raise ValueError(
                f"a server's first mesh spans the world: {mesh!r} holds "
                f"{len(mesh.ranks)} of its {world} ranks (a reshard moves "
                "it onto fewer)")
        return cls(head=world_group(IDLE_TIMEOUT),
                   group=world_group(2 * mesh.timeout), leader=mesh.leader,
                   rank=dist.get_rank(), world=world)

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def _broadcast(self, t: torch.Tensor, group=None) -> torch.Tensor:
        dist.broadcast(t, self.leader,
                       group=self.group if group is None else group)
        if not self.is_leader:
            annotate.TRAFFIC[LABEL] += t.nbytes
        return t

    def send(self, op: int, floor: int, fields=(), tensors=()) -> None:
        """The leader: one command."""
        head = torch.zeros(HEADER, dtype=torch.int64)
        head[:2 + len(fields)] = torch.tensor((op, floor, *fields))
        self._broadcast(head, self.head)
        for t in tensors:
            self._broadcast(torch.as_tensor(t).contiguous())

    def recv(self) -> tuple[int, int, list[int]]:
        """A follower: the next command's (op, floor, fields)."""
        head = self._broadcast(torch.zeros(HEADER, dtype=torch.int64),
                               self.head)
        op, floor, *fields = head.tolist()
        return op, floor, fields

    def recv_tensor(self, shape, dtype) -> torch.Tensor:
        return self._broadcast(torch.empty(tuple(shape), dtype=dtype))

    def broadcast_int(self, value: int) -> int:
        """The leader's ``value`` on every rank."""
        return int(self._broadcast(torch.tensor([value]))[0])

    def statuses(self, status: int) -> list[int]:
        """Every rank's status after a command, by world rank."""
        mine = torch.tensor([status], dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine, group=self.group)
        annotate.TRAFFIC[LABEL] += (self.world - 1) * mine.nbytes
        return [int(p) for p in parts]
