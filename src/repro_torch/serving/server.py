"""``EmdServer``: the async online runtime over a prebuilt ``EmdIndex``.

The batched engines amortize Phase 1 across a query batch, but a live
service receives queries one at a time from concurrent callers: this
module FORMS the batches. Three cooperating pieces:

* **Micro-batching queue**: concurrent ``await server.search(...)`` calls
  coalesce into one padded device launch, flushed when the batch fills
  (``policy.max_batch``) OR the oldest request has waited
  ``policy.flush_ms``. The query count pads up to the next power-of-two
  bucket, so the launches see a small, fixed set of shapes.
* **Policy layer**: per-request deadlines, bounded retry-with-backoff
  around every device launch, and graceful degradation: on repeated
  launch failure or deadline pressure the batch steps down the
  ``ServingPolicy`` ladder of cascade presets / cheap methods; the
  response carries the tier actually served and its recall expectation.
  Load shedding (``ServerOverloaded``) is the final rung, a fast fail,
  never a silent timeout.
* **Generational index lifecycle**: the corpus and the per-tier built
  indexes live in an immutable ``_Generation``; ``append``/``delete``
  build a new generation and swap the reference, so in-flight batches
  finish on the snapshot they started on. Snapshot/restore lives in
  ``serving/lifecycle.py``, deterministic fault injection in
  ``serving/chaos.py``.

**On a mesh** (an index with ``backend="distributed"`` over a
``torch.distributed`` mesh of more than one rank) every rank builds the
server from the same index and every tier is built on the mesh. The rank
at (data 0, model 0) is the leader: it alone runs the queue, the policy,
the ladder and the stats, and sends each launch, mutation, reshard and
stop to the others (``serving/control.py``), which run them in order in
:meth:`EmdServer.follow`. The launch's broadcast is inside
``_raw_launch``, the function the launch hook wraps, so a launch the hook
fails or delays before calling it reaches no follower. A launch that fails
on any rank after its broadcast is a device fault on the leader
(``MeshFault``): the ranks' collectives may be out of step. A follower
keeps each generation that a batch in flight may still launch on, as the
leader's batches do. :meth:`EmdServer.reshard` moves the server onto a
new mesh over any ranks of the world that keep the leader at (0, 0): the
ranks create its groups together inside the command, each rank of it
builds every tier on it from the corpus it holds (every rank holds the
whole corpus, so no row moves), and ranks outside it stay in their loop,
idle, until a later reshard takes them back. A failure of the channel
itself (a broadcast or the status exchange) is a ``MeshFault`` too, and
the leader sends nothing more on it.

Launches run synchronously on the event loop: one host drives one device,
so overlapping launches would only contend; while a launch runs, new
arrivals queue up, which is what the micro-batcher wants. A launch returns
numpy arrays (``.cpu()`` waits for the device), so the tier latency that
deadline pressure reads is the device's real time.

**Device faults are not retried.** A CUDA error poisons the context (every
later launch fails too), and a kernel's build or launch error
(``KernelError``) is a fault of the program that a cheaper tier would
only hide. Either one fails the batch's requests with it, and the server
then refuses every queued and later request with a ``RuntimeError`` that
names it (``stats.device_faults`` counts them); a restart, e.g. from a
snapshot, is the recovery. Every other launch exception (an injected
``FaultInjected``, an out-of-memory error) is retried and degraded as in
the JAX package.

The port's copy of the JAX package's ``serving/server.py``, on tensors.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.api.index import EmdIndex
from repro_torch.core.lc import Corpus
from repro_torch.kernels._build import KernelError
from repro_torch.launch.mesh import MESH_BACKENDS, Mesh, join_mesh, plan_mesh
from repro_torch.serving import control as ctl
from repro_torch.serving.policy import (ServerOverloaded, ServingPolicy,
                                        ServingTier, validate_ladder)


def _device_fault(e: BaseException) -> bool:
    """True for an exception no retry or cheaper tier can serve past: a
    kernel's build or launch error, a CUDA error, or a failure of a
    command on a rank of the mesh."""
    cuda_error = getattr(torch, "AcceleratorError", ())
    return isinstance(e, (KernelError, ctl.MeshFault, cuda_error)) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e))


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served request. ``indices`` are EXTERNAL doc ids (stable under
    append/delete), ``tier``/``expected_recall`` label the quality level
    actually served (``degraded`` = below the ladder's first rung), and
    ``generation`` names the corpus snapshot that answered."""
    scores: np.ndarray
    indices: np.ndarray
    tier: str
    expected_recall: float | None
    degraded: bool
    generation: int
    retries: int
    latency_ms: float


@dataclasses.dataclass
class ServerStats:
    """Mutable counters exposed for tests and measurement (not
    thread-safe: the server is single-loop by design)."""
    requests: int = 0
    launches: int = 0
    launch_failures: int = 0
    device_faults: int = 0
    flushes: int = 0
    shed: int = 0
    tier_served: dict = dataclasses.field(default_factory=dict)
    bucket_launches: dict = dataclasses.field(default_factory=dict)
    tier_latency_ms: dict = dataclasses.field(default_factory=dict)

    def count_tier(self, name: str, k: int) -> None:
        self.tier_served[name] = self.tier_served.get(name, 0) + k

    def ewma(self, name: str, ms: float, alpha: float = 0.3) -> None:
        prev = self.tier_latency_ms.get(name)
        self.tier_latency_ms[name] = ms if prev is None else \
            (1 - alpha) * prev + alpha * ms


@dataclasses.dataclass
class _Request:
    q_ids: np.ndarray
    q_w: np.ndarray
    future: asyncio.Future
    t_enqueue: float
    deadline_s: float


@dataclasses.dataclass(frozen=True)
class _BuiltTier:
    tier: ServingTier
    index: EmdIndex
    rank: int                       # position in the ladder (0 = primary)


@dataclasses.dataclass(frozen=True)
class _Generation:
    """Immutable corpus snapshot + the per-tier indexes built over it.
    In-flight batches hold a reference; mutations swap the server's
    pointer to a freshly built generation."""
    gen: int
    corpus: Corpus
    doc_ids: np.ndarray             # (n,) int64 external ids, row-aligned
    tiers: tuple[_BuiltTier, ...]   # () on a rank outside the mesh


def _tier_config(config: EngineConfig, tier: ServingTier) -> EngineConfig:
    """The EngineConfig a non-primary rung's index is built with: same
    backend/batch knobs, the rung's cascade or method swapped in."""
    if tier.cascade is not None:
        return dataclasses.replace(config, cascade=tier.cascade,
                                   symmetric=False)
    # Method rung: directional full-corpus scan with the cheap measure.
    return dataclasses.replace(config, method=tier.method, cascade=None,
                               symmetric=False, iters=0)


def _build_generation(gen: int, corpus: Corpus, doc_ids: np.ndarray,
                      config: EngineConfig, tiers: tuple[ServingTier, ...],
                      mesh: Mesh | None,
                      reuse_primary: EmdIndex | None) -> _Generation:
    """Every tier over ``corpus``: on ``mesh`` for the distributed backend
    (none on a rank outside the mesh, ``mesh=None``), else on the
    corpus's device."""
    built = []
    idle = config.backend == "distributed" and mesh is None
    for rank, tier in enumerate(() if idle else tiers):
        cfg = config if tier.name == "primary" else \
            _tier_config(config, tier)
        if tier.name == "primary" and reuse_primary is not None:
            index = reuse_primary
        elif mesh is None:
            index = EmdIndex.build(corpus, cfg, corpus.device)
        else:
            index = EmdIndex.build(corpus, cfg, mesh=mesh)
        built.append(_BuiltTier(tier=tier, index=index, rank=rank))
    return _Generation(gen=gen, corpus=corpus,
                       doc_ids=np.asarray(doc_ids, np.int64),
                       tiers=tuple(built))


class EmdServer:
    """Async serving runtime over a prebuilt :class:`EmdIndex`.

        index = EmdIndex.build(corpus, EngineConfig(method="act", iters=3))
        server = EmdServer(index, ServingPolicy(max_batch=16, flush_ms=2))
        async with server:
            res = await server.search(q_ids, q_w)     # one (h,) query
        res.scores, res.indices, res.tier, res.generation

    ``launch_hook`` wraps every device-launch attempt (called as
    ``hook(launch_fn, tier, Q_ids, Q_w)``): the chaos-injection seam.
    Every tier's index lives on the primary index's device, or on its
    mesh.

    On a mesh of more than one rank every rank of the world builds the
    server from its part of the same index (its mesh must span the
    world); the leader (:attr:`is_leader`) then serves as above while
    every other rank runs :meth:`follow`:

        if server.is_leader:
            async with server:                    # stop() ends follow()
                res = await server.search(q_ids, q_w)
        else:
            server.follow()

    A follower's ``launch_hook`` wraps its part of each launch (the
    command has arrived): what it raises fails the launch on the leader.
    ``control``: the channel to the followers when the caller made it
    already (``restore_server``), else the constructor makes it.
    """

    def __init__(self, index: EmdIndex, policy: ServingPolicy | None = None,
                 *, launch_hook=None, doc_ids=None, generation: int = 0,
                 next_doc_id: int | None = None,
                 time_fn=time.monotonic, control=None) -> None:
        self.policy = policy if policy is not None else ServingPolicy()
        self.config = index.config
        self.stats = ServerStats()
        self._hook = launch_hook
        self._clock = time_fn
        self._mesh = index.mesh
        n = index.corpus.n
        tiers = validate_ladder(self.policy, self.config, n,
                                self.config.top_l)
        self._ladder = tiers
        if control is None and self._mesh is not None:
            control = ctl.Control.create(self._mesh)
        self._control = control
        if doc_ids is None:
            doc_ids = np.arange(n, dtype=np.int64)
        doc_ids = np.asarray(doc_ids, np.int64)
        if doc_ids.shape != (n,):
            raise ValueError(f"doc_ids shape {doc_ids.shape} != ({n},)")
        self._next_doc_id = int(next_doc_id) if next_doc_id is not None \
            else (int(doc_ids.max()) + 1 if n else 0)
        self._gen = _build_generation(generation, index.corpus, doc_ids,
                                      self.config, tiers, self._mesh,
                                      reuse_primary=index)
        # Generations a batch in flight may still launch on: the leader
        # counts its batches by generation (each batch holds its own), a
        # follower keeps the generations by number (the leader sends the
        # oldest it still needs with every command).
        self._inflight: collections.Counter = collections.Counter()
        self._gens = {} if self.is_leader else {self._gen.gen: self._gen}
        self._pending: list[_Request] = []
        self._arrival = asyncio.Event()
        self._running = False
        self._fault: BaseException | None = None
        self._lost = False              # the channel failed: send no more
        self._flusher: asyncio.Task | None = None
        # (tier, bucket) shapes launched at least once: the FIRST launch of
        # a shape may build and load kernels, so its wall time is excluded
        # from the tier latency estimate; otherwise one cold start would
        # read as deadline pressure and degrade the next batches.
        self._warm: set[tuple[str, int]] = set()

    # ------------------------------------------------------------ lifecycle
    @property
    def generation(self) -> int:
        return self._gen.gen

    @property
    def corpus(self) -> Corpus:
        return self._gen.corpus

    @property
    def doc_ids(self) -> np.ndarray:
        return self._gen.doc_ids

    @property
    def tiers(self) -> tuple[ServingTier, ...]:
        return self._ladder

    @property
    def mesh(self) -> Mesh | None:
        """The mesh this rank's tiers run on (None off a mesh, and on a
        rank that a reshard left outside it)."""
        return self._mesh

    @property
    def is_leader(self) -> bool:
        """True where the queue runs: off a mesh, or on its leader."""
        return self._control is None or self._control.is_leader

    def _check_leader(self, what: str) -> None:
        if not self.is_leader:
            raise RuntimeError(
                f"{what} runs on the leader (world rank "
                f"{self._control.leader}); rank {self._control.rank} "
                "follows it: call follow()")

    async def start(self) -> None:
        self._check_leader("EmdServer.start")
        if self._running:
            return
        self._running = True
        # An event binds to the loop that first waits on it: each run of
        # the server (each asyncio.run) gets its own.
        self._arrival = asyncio.Event()
        self._flusher = asyncio.get_running_loop().create_task(
            self._flush_loop())

    async def stop(self) -> None:
        """Drain the queue (every queued request is served or shed), then
        stop the flusher."""
        if not self._running:
            return
        self._running = False
        self._arrival.set()
        if self._flusher is not None:
            await self._flusher
            self._flusher = None
        if self._control is not None and not self._lost:
            self._control.send(ctl.STOP, self._floor())

    async def __aenter__(self) -> "EmdServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -------------------------------------------------------------- serving
    def _refusal(self) -> RuntimeError:
        return RuntimeError(f"EmdServer stopped serving after a device "
                            f"fault: {self._fault!r}")

    async def search(self, q_ids, q_w, *,
                     deadline_ms: float | None = None) -> ServeResult:
        """Serve one ``(h,)`` query; coalesced with concurrent callers
        into a micro-batched device launch. Raises
        :class:`ServerOverloaded` when every ladder rung failed (load
        shedding), and ``RuntimeError`` if the server is not started or
        has stopped serving after a device fault."""
        self._check_leader("EmdServer.search")
        if not self._running:
            raise RuntimeError("EmdServer is not running; use "
                               "'async with server:' or await start()")
        if self._fault is not None:
            raise self._refusal()
        q_ids = np.asarray(q_ids)
        q_w = np.asarray(q_w)
        if q_ids.ndim != 1 or q_ids.shape != q_w.shape:
            raise ValueError(
                f"EmdServer.search takes one (h,) query per call, got ids "
                f"{q_ids.shape} / w {q_w.shape} (batching is the queue's "
                "job)")
        deadline = (self.policy.deadline_ms if deadline_ms is None
                    else deadline_ms) / 1e3
        req = _Request(q_ids=q_ids, q_w=q_w,
                       future=asyncio.get_running_loop().create_future(),
                       t_enqueue=self._clock(), deadline_s=deadline)
        self.stats.requests += 1
        self._pending.append(req)
        self._arrival.set()
        return await req.future

    async def _flush_loop(self) -> None:
        flush_s = self.policy.flush_ms / 1e3
        while True:
            if not self._pending:
                if not self._running:
                    return
                self._arrival.clear()
                if self._pending:        # arrival raced the clear
                    continue
                await self._arrival.wait()
                continue
            # Fill-or-deadline: wait for more arrivals until the batch is
            # full or the oldest request has waited flush_ms.
            while (self._running and self._fault is None
                   and len(self._pending) < self.policy.max_batch):
                remaining = flush_s - (self._clock()
                                       - self._pending[0].t_enqueue)
                if remaining <= 0:
                    break
                self._arrival.clear()
                try:
                    await asyncio.wait_for(self._arrival.wait(), remaining)
                except (asyncio.TimeoutError, TimeoutError):
                    break
            batch = self._pending[:self.policy.max_batch]
            del self._pending[:len(batch)]
            if self._fault is not None:
                self._fail(batch, self._refusal())
                continue
            await self._serve_batch(batch)

    def _bucket(self, nq: int) -> int:
        """Next power-of-two >= nq, capped at max_batch: the padded query
        count of the launch, so the launches see O(log max_batch) distinct
        shapes."""
        b = 1
        while b < nq:
            b <<= 1
        return min(b, self.policy.max_batch)

    def _start_rank(self, gen: _Generation, batch: list[_Request]) -> int:
        """Deadline pressure: the rung the batch starts at, the first tier
        whose latency estimate (when known) fits the TIGHTEST remaining
        deadline in the batch with headroom. The batch shares one launch,
        so the most-pressured request decides."""
        now = self._clock()
        tightest = min(r.deadline_s - (now - r.t_enqueue) for r in batch)
        for built in gen.tiers:
            est = self.stats.tier_latency_ms.get(built.tier.name)
            if est is None or est / 1e3 * self.policy.headroom <= tightest:
                return built.rank
        return len(gen.tiers) - 1

    def _floor(self) -> int:
        """The oldest generation a batch in flight may still launch on."""
        return min([self._gen.gen, *self._inflight])

    @staticmethod
    def _local_launch(built: _BuiltTier, Q_ids, Q_w):
        scores, idx = built.index.search(torch.from_numpy(Q_ids),
                                         torch.from_numpy(Q_w))
        return scores.cpu().numpy(), idx.cpu().numpy()

    def _raw_launch(self, gen: _Generation, built: _BuiltTier, Q_ids, Q_w):
        """One launch of ``built``'s tier of ``gen``: on a mesh, the
        command to every follower first, then this rank's part, then the
        status exchange."""
        if self._control is None:
            return self._local_launch(built, Q_ids, Q_w)
        return self._together(
            lambda: self._local_launch(built, Q_ids, Q_w),
            ctl.LAUNCH, (gen.gen, built.rank, *Q_ids.shape),
            (torch.from_numpy(Q_ids), torch.from_numpy(Q_w)))

    def _channel_fault(self, what: str, e: Exception) -> ctl.MeshFault:
        self._lost = True
        return ctl.MeshFault(f"the control channel failed {what}: {e!r}")

    def _together(self, fn, op=None, fields=(), tensors=()):
        """The leader sends command ``op`` to every follower (a follower
        has received it), then each rank runs its part ``fn``, then the
        status exchange. The leader raises :class:`MeshFault` if any rank
        failed, or if the channel itself did; a follower records its own
        failure and goes on following."""
        c = self._control
        if op is not None:
            try:
                c.send(op, self._floor(), tuple(fields), tensors)
            except Exception as e:             # noqa: BLE001 - reported
                raise self._channel_fault("sending a command", e) from e
        try:
            out, err = fn(), None
        except Exception as e:                 # noqa: BLE001 - reported
            out, err = None, e
        try:
            statuses = c.statuses(ctl.OK if err is None else ctl.FAILED)
        except Exception as e:                 # noqa: BLE001 - reported
            if not self.is_leader:
                raise
            raise self._channel_fault("in the status exchange", e) from e
        if not self.is_leader:
            if err is not None:
                self.stats.launch_failures += 1
                self.stats.device_faults += int(_device_fault(err))
                self._fault = err
            return out
        failed = [r for r, s in enumerate(statuses) if s != ctl.OK]
        if failed:
            here = "" if err is None else f"; here {err!r}"
            raise ctl.MeshFault(f"the command failed on world ranks "
                                f"{failed}{here}") from err
        return out

    @staticmethod
    def _fail(batch: list[_Request], exc: BaseException) -> None:
        for r in batch:
            if not r.future.done():
                r.future.set_exception(exc)

    async def _serve_batch(self, batch: list[_Request]) -> None:
        gen = self._gen                      # snapshot: mutations swap it
        self._inflight[gen.gen] += 1
        try:
            await self._serve_on(gen, batch)
        finally:
            self._inflight[gen.gen] -= 1
            if not self._inflight[gen.gen]:
                del self._inflight[gen.gen]

    async def _serve_on(self, gen: _Generation,
                        batch: list[_Request]) -> None:
        self.stats.flushes += 1
        nq = len(batch)
        bucket = self._bucket(nq)
        hmax = gen.corpus.hmax
        Q_ids = np.zeros((bucket, hmax), np.int32)
        Q_w = np.zeros((bucket, hmax), np.float32)
        for i, r in enumerate(batch):
            h = min(r.q_ids.shape[0], hmax)
            Q_ids[i, :h] = r.q_ids[:h]
            Q_w[i, :h] = r.q_w[:h]
        self.stats.bucket_launches[bucket] = \
            self.stats.bucket_launches.get(bucket, 0) + 1

        start = self._start_rank(gen, batch)
        retries = 0
        for built in gen.tiers[start:]:
            # The hook contract sees the ServingTier (its name labels the
            # rung); the built index rides along in the closure.
            def launch(tier, q_ids, q_w, _built=built):
                return self._raw_launch(gen, _built, q_ids, q_w)

            for attempt in range(self.policy.max_retries + 1):
                try:
                    t0 = time.perf_counter()
                    self.stats.launches += 1
                    if self._hook is not None:
                        scores, idx = self._hook(launch, built.tier,
                                                 Q_ids, Q_w)
                    else:
                        scores, idx = launch(built.tier, Q_ids, Q_w)
                    dt_ms = (time.perf_counter() - t0) * 1e3
                except Exception as e:
                    self.stats.launch_failures += 1
                    if _device_fault(e):
                        self.stats.device_faults += 1
                        self._fault = e
                        self._fail(batch, e)
                        return
                    retries += 1
                    if attempt < self.policy.max_retries:
                        await asyncio.sleep(
                            self.policy.backoff_ms * 2 ** attempt / 1e3)
                    continue
                if (built.tier.name, bucket) in self._warm:
                    self.stats.ewma(built.tier.name, dt_ms)
                else:
                    self._warm.add((built.tier.name, bucket))
                self.stats.count_tier(built.tier.name, nq)
                self._resolve(batch, gen, built, scores, idx,
                              retries=retries)
                return
        # Ladder exhausted: shed (fast-fail, the final rung).
        self.stats.shed += nq
        self._fail(batch, ServerOverloaded(
            f"all {len(gen.tiers[start:])} ladder rung(s) failed after "
            f"{retries} launch failure(s)"))

    def _resolve(self, batch, gen: _Generation, built: _BuiltTier,
                 scores: np.ndarray, idx: np.ndarray, *,
                 retries: int) -> None:
        now = self._clock()
        ext = gen.doc_ids[idx]               # internal row -> external id
        for i, r in enumerate(batch):
            if r.future.done():              # e.g. caller cancelled
                continue
            r.future.set_result(ServeResult(
                scores=scores[i], indices=ext[i],
                tier=built.tier.name,
                expected_recall=built.tier.expected_recall,
                degraded=built.rank > 0,
                generation=gen.gen, retries=retries,
                latency_ms=(now - r.t_enqueue) * 1e3))

    # ------------------------------------------------- corpus mutation
    def append(self, ids, w) -> np.ndarray:
        """Append document rows (``(k, hmax)`` ids/weights) as a new
        generation; returns the external doc ids assigned. In-flight
        batches finish on the previous snapshot; the next flush serves
        the new one. On a mesh every rank builds it."""
        self._check_leader("append")
        gen = self._gen
        ids = np.asarray(ids, np.int32)
        w = np.asarray(w, np.float32)
        if ids.ndim != 2 or ids.shape != w.shape \
                or ids.shape[1] != gen.corpus.hmax:
            raise ValueError(
                f"append takes (k, hmax={gen.corpus.hmax}) rows, got ids "
                f"{ids.shape} / w {w.shape}")
        if ids.size and (int(ids.max()) >= gen.corpus.v
                         or int(ids.min()) < 0):
            raise ValueError("append row ids must lie in the vocabulary "
                             f"[0, {gen.corpus.v}), got [{int(ids.min())}, "
                             f"{int(ids.max())}]")
        return self._command(ctl.APPEND, ids.shape,
                             (torch.from_numpy(ids), torch.from_numpy(w)),
                             lambda: self._apply_append(ids, w))

    def _apply_append(self, ids: np.ndarray, w: np.ndarray) -> np.ndarray:
        gen = self._gen
        k = ids.shape[0]
        new_ids = np.arange(self._next_doc_id, self._next_doc_id + k,
                            dtype=np.int64)
        self._next_doc_id += k
        c, device = gen.corpus, gen.corpus.device
        corpus = Corpus(
            ids=torch.cat([c.ids, torch.from_numpy(ids).to(device)]),
            w=torch.cat([c.w, torch.from_numpy(w).to(device)]),
            coords=c.coords)
        self._swap(corpus, np.concatenate([gen.doc_ids, new_ids]))
        return new_ids

    def delete(self, doc_ids) -> int:
        """Delete documents by EXTERNAL id (row-block removal: Phase-1
        tables are row-independent); returns rows removed. Surviving
        documents keep their external ids. Unknown ids are an error: a
        delete that silently no-ops would hide a lost mutation."""
        self._check_leader("delete")
        gen = self._gen
        drop = np.asarray(doc_ids, np.int64).ravel()
        missing = np.setdiff1d(drop, gen.doc_ids)
        if missing.size:
            raise KeyError(f"unknown doc ids: {missing.tolist()}")
        keep = ~np.isin(gen.doc_ids, drop)
        if int(keep.sum()) < self.config.top_l:
            raise ValueError(
                f"delete would leave {int(keep.sum())} rows < "
                f"top_l={self.config.top_l}")
        return self._command(ctl.DELETE, drop.shape,
                             (torch.from_numpy(drop),),
                             lambda: self._apply_delete(drop))

    def _apply_delete(self, drop: np.ndarray) -> int:
        gen = self._gen
        keep = ~np.isin(gen.doc_ids, drop)
        c = gen.corpus
        rows = torch.from_numpy(np.nonzero(keep)[0]).to(c.device)
        corpus = Corpus(ids=c.ids[rows], w=c.w[rows], coords=c.coords)
        self._swap(corpus, gen.doc_ids[keep])
        return int((~keep).sum())

    def reshard(self, new_mesh: Mesh) -> None:
        """Recovery on mesh change: every tier of the current corpus on
        ``new_mesh``, as a new generation; in-flight batches finish on the
        old mesh's generation. A single-device backend ignores the mesh
        (the tiers are built again, as a new generation), as in the JAX
        package.

        In a world of more than one rank ``new_mesh`` is a plan
        (``launch.mesh.plan_mesh``) over any ranks of the world with the
        leader at data 0, model 0: every rank creates its groups inside
        the command, each rank of it builds every tier on it from the
        corpus it holds, and the ranks outside it idle in :meth:`follow`.
        In a world of one rank it may be joined."""
        if not isinstance(new_mesh, Mesh):
            raise ValueError(f"reshard takes a repro_torch.launch.mesh.Mesh, "
                             f"got {type(new_mesh).__name__}")
        self._check_leader("reshard")
        if self.config.backend != "distributed":
            self._swap(self._gen.corpus, self._gen.doc_ids)
            return
        if self._control is None:
            mesh = new_mesh if new_mesh.joined else join_mesh(new_mesh)
            if mesh is None:
                raise ValueError(f"{new_mesh!r} leaves out this rank")
            self._apply_reshard(mesh)
            return
        if new_mesh.joined:
            raise ValueError(
                f"in a world of {self._control.world} ranks reshard takes a "
                "plan (launch.mesh.plan_mesh): every rank creates its "
                f"groups inside the command, got a joined {new_mesh!r}")
        if new_mesh.leader != self._control.leader \
                or new_mesh.backend != self._mesh.backend:
            raise ValueError(
                f"{new_mesh!r} over ranks {new_mesh.ranks} must keep the "
                f"leader (world rank {self._control.leader}) at data 0, "
                f"model 0 and the backend {self._mesh.backend!r}")
        d = new_mesh.device
        fields = (new_mesh.size("data"), new_mesh.size("model"),
                  MESH_BACKENDS.index(new_mesh.backend),
                  int(d.type == "cuda"), -1 if d.index is None else d.index,
                  round(new_mesh.timeout * 1e3))
        self._command(ctl.RESHARD, fields,
                      (torch.tensor(new_mesh.ranks, dtype=torch.int64),),
                      lambda: self._apply_reshard(join_mesh(new_mesh)))

    def _apply_reshard(self, mesh: Mesh | None) -> None:
        """Every rank: every tier of the current generation on ``mesh``
        (this rank's part; none outside it). Every rank holds the whole
        corpus, so each slices its own rows from it."""
        self._mesh = mesh
        self._swap(self._gen.corpus, self._gen.doc_ids)

    def _command(self, op: int, fields, tensors, fn):
        """A mutation on the leader: sent to every follower, run here,
        then the status exchange. A failure on any rank leaves the ranks'
        generations apart: the server refuses every later request."""
        if self._control is None:
            return fn()
        if self._lost:
            raise self._refusal()
        try:
            return self._together(fn, op, fields, tensors)
        except ctl.MeshFault as e:
            self.stats.device_faults += 1
            self._fault = e
            raise

    def _swap(self, corpus: Corpus, doc_ids: np.ndarray) -> None:
        gen = self._gen
        self._gen = _build_generation(gen.gen + 1, corpus, doc_ids,
                                      self.config, self._ladder, self._mesh,
                                      reuse_primary=None)
        if not self.is_leader:
            self._gens[self._gen.gen] = self._gen

    def _prune(self, floor: int) -> None:
        for g in [g for g in self._gens if g < floor]:
            del self._gens[g]

    # ------------------------------------------------------------ follower
    def follow(self) -> None:
        """A follower's loop: run the leader's commands, in the order it
        sends them, until its ``stop()``. A launch runs this rank's part on
        the generation the leader's batch holds (nothing on a rank outside
        that generation's mesh); a mutation or a reshard builds the same
        next generation as the leader. What fails here fails the command
        on the leader; this rank goes on following."""
        if self._control is None or self._control.is_leader:
            raise RuntimeError("follow() runs on a follower rank of a mesh "
                               "server")
        c = self._control
        while True:
            op, floor, f = c.recv()
            self._prune(floor)
            if op == ctl.STOP:
                return
            if op == ctl.LAUNCH:
                g, tier, bucket, hmax = f[:4]
                Q_ids = c.recv_tensor((bucket, hmax), torch.int32).numpy()
                Q_w = c.recv_tensor((bucket, hmax), torch.float32).numpy()
                fn = functools.partial(self._follow_launch, g, tier, Q_ids,
                                       Q_w)
            elif op == ctl.APPEND:
                ids = c.recv_tensor(f[:2], torch.int32).numpy()
                w = c.recv_tensor(f[:2], torch.float32).numpy()
                fn = functools.partial(self._apply_append, ids, w)
            elif op == ctl.DELETE:
                drop = c.recv_tensor(f[:1], torch.int64).numpy()
                fn = functools.partial(self._apply_delete, drop)
            elif op == ctl.RESHARD:
                n_data, n_model, backend, cuda, index, ms = f[:6]
                ranks = c.recv_tensor((n_data * n_model,), torch.int64)
                device = torch.device("cpu") if not cuda else (
                    torch.device("cuda") if index < 0
                    else torch.device("cuda", index))
                plan = plan_mesh(n_data, n_model, ranks=ranks.tolist(),
                                 backend=MESH_BACKENDS[backend],
                                 device=device, timeout=ms / 1e3)
                fn = functools.partial(
                    lambda p: self._apply_reshard(join_mesh(p)), plan)
            else:
                raise RuntimeError(f"unknown command {op} from the leader")
            self._together(fn)

    def _follow_launch(self, g: int, tier: int, Q_ids, Q_w):
        gen = self._gens[g]
        if not gen.tiers:                     # outside this mesh
            return None
        built = gen.tiers[tier]
        self.stats.launches += 1
        if self._hook is None:
            return self._local_launch(built, Q_ids, Q_w)
        return self._hook(lambda t, a, b: self._local_launch(built, a, b),
                          built.tier, Q_ids, Q_w)
