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
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.api.index import EmdIndex
from repro_torch.core.lc import Corpus
from repro_torch.kernels._build import KernelError
from repro_torch.serving.policy import (ServerOverloaded, ServingPolicy,
                                        ServingTier, validate_ladder)


def _device_fault(e: BaseException) -> bool:
    """True for an exception no retry or cheaper tier can serve past: a
    kernel's build or launch error, or a CUDA error."""
    cuda_error = getattr(torch, "AcceleratorError", ())
    return isinstance(e, (KernelError, cuda_error)) or (
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
    tiers: tuple[_BuiltTier, ...]


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
                      reuse_primary: EmdIndex | None) -> _Generation:
    built = []
    for rank, tier in enumerate(tiers):
        if tier.name == "primary":
            index = reuse_primary if reuse_primary is not None else \
                EmdIndex.build(corpus, config, corpus.device)
        else:
            index = EmdIndex.build(corpus, _tier_config(config, tier),
                                   corpus.device)
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
    Every tier's index lives on the primary index's device.
    """

    def __init__(self, index: EmdIndex, policy: ServingPolicy | None = None,
                 *, launch_hook=None, doc_ids=None, generation: int = 0,
                 next_doc_id: int | None = None,
                 time_fn=time.monotonic) -> None:
        self.policy = policy if policy is not None else ServingPolicy()
        self.config = index.config
        self.stats = ServerStats()
        self._hook = launch_hook
        self._clock = time_fn
        n = index.corpus.n
        tiers = validate_ladder(self.policy, self.config, n,
                                self.config.top_l)
        if doc_ids is None:
            doc_ids = np.arange(n, dtype=np.int64)
        doc_ids = np.asarray(doc_ids, np.int64)
        if doc_ids.shape != (n,):
            raise ValueError(f"doc_ids shape {doc_ids.shape} != ({n},)")
        self._next_doc_id = int(next_doc_id) if next_doc_id is not None \
            else (int(doc_ids.max()) + 1 if n else 0)
        self._gen = _build_generation(generation, index.corpus, doc_ids,
                                      self.config, tiers,
                                      reuse_primary=index)
        self._pending: list[_Request] = []
        self._arrival = asyncio.Event()
        self._running = False
        self._fault: BaseException | None = None
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
        return tuple(b.tier for b in self._gen.tiers)

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
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

    def _raw_launch(self, built: _BuiltTier, Q_ids, Q_w):
        scores, idx = built.index.search(torch.from_numpy(Q_ids),
                                         torch.from_numpy(Q_w))
        return scores.cpu().numpy(), idx.cpu().numpy()

    @staticmethod
    def _fail(batch: list[_Request], exc: BaseException) -> None:
        for r in batch:
            if not r.future.done():
                r.future.set_exception(exc)

    async def _serve_batch(self, batch: list[_Request]) -> None:
        gen = self._gen                      # snapshot: mutations swap it
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
                return self._raw_launch(_built, q_ids, q_w)

            for attempt in range(self.policy.max_retries + 1):
                try:
                    t0 = time.perf_counter()
                    self.stats.launches += 1
                    if self._hook is not None:
                        scores, idx = self._hook(launch, built.tier,
                                                 Q_ids, Q_w)
                    else:
                        scores, idx = self._raw_launch(built, Q_ids, Q_w)
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
        the new one."""
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
        c = gen.corpus
        rows = torch.from_numpy(np.nonzero(keep)[0]).to(c.device)
        corpus = Corpus(ids=c.ids[rows], w=c.w[rows], coords=c.coords)
        self._swap(corpus, gen.doc_ids[keep])
        return int((~keep).sum())

    def reshard(self, new_mesh) -> None:
        """Recovery on mesh change (the JAX package's distributed backend):
        not yet ported. The mesh scores and searches; resharding a live
        server onto a new process group is the next slice (ROADMAP Queue 1
        item 6, second half)."""
        raise ValueError("EmdServer.reshard is not yet ported: resharding a "
                         "live server is the next slice (ROADMAP Queue 1 "
                         "item 6, second half)")

    def _swap(self, corpus: Corpus, doc_ids: np.ndarray) -> None:
        gen = self._gen
        tiers = tuple(b.tier for b in gen.tiers)
        self._gen = _build_generation(gen.gen + 1, corpus, doc_ids,
                                      self.config, tiers,
                                      reuse_primary=None)
