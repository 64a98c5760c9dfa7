"""``EmdIndex``: build once over a corpus, then score and search query
batches, on one device or on the shards of a (data, model) mesh.

    index = EmdIndex.build(corpus, EngineConfig(method="act", iters=7))
    scores = index.scores(q_ids, q_w)          # (h,) -> (n,), (nq, h) -> (nq, n)
    top, idx = index.search(q_ids, q_w)        # top-l neighbours
    top, idx = index.search(q_ids, q_w, cascade="chain")   # prune + rescore
    S = index.all_pairs()                      # n x n symmetric matrix
    p = index.precision_at_l(labels, 8)        # corpus-as-queries

When the config's cascade names a sublinear candidate source
(``repro_torch.candidates``), ``build`` fits its index on the host once and
``search`` passes the built source to the cascade.

The index lives on a CUDA device unless the caller asks for the CPU. A
single query runs through the single-query engine
(``retrieval.query_scores``, float32 whatever the precision policy), a
batch through ``retrieval.batch_scores`` with ``config.batch_engine``:
``batched`` (Phase 1 once per batch) or ``scan`` (a loop of the
single-query engine), as in the JAX package.

With ``EngineConfig(backend="distributed")`` and a ``mesh``
(``repro_torch.launch.mesh.Mesh``), every rank of the mesh builds the
index from the same corpus and keeps its shard: the rows padded to
``config.pad_multiple`` and split over ``model``, the coordinates whole,
the candidate source's tables whole. Every rank then passes the same
queries to ``scores`` / ``search`` / ``all_pairs`` and gets the whole
result back (``launch/search.py`` holds the steps); queries, single ones
included, go as a batch padded to the ``data`` size.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api.config import EngineConfig
from repro_torch.cascade import cascade_search, resolve_spec
from repro_torch.core import lc, retrieval
from repro_torch.core.lc import Corpus
from repro_torch.launch.mesh import Mesh


def corpus_from_numpy(ids, w, coords, device) -> Corpus:
    """A :class:`Corpus` on ``device`` from numpy-convertible arrays: the
    JAX package's ``Corpus`` fields (``np.asarray`` of each) carried across
    unchanged. ids (n, hmax) int, w (n, hmax) float32, coords (v, m)."""
    return Corpus(
        ids=torch.tensor(np.asarray(ids, np.int32), device=device),
        w=torch.tensor(np.asarray(w, np.float32), device=device),
        coords=torch.tensor(np.asarray(coords, np.float32), device=device))


def _to_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _placed_source(config: EngineConfig, corpus: Corpus, source, device):
    """The built candidate source of ``config``'s cascade on ``device``:
    ``source`` when given (it must match the config's source spec), else
    fitted over ``corpus`` on the host; ``None`` when the cascade is
    unsourced or full-scan."""
    src_spec = config.source_spec
    if src_spec is None or src_spec.full_scan:
        return None
    if source is None:
        source = src_spec.build(corpus)
    elif source.spec != src_spec:
        raise ValueError(f"injected source {source.spec.describe()} does "
                         f"not match config's {src_spec.describe()}")
    return source.to(device)


def _row_shard(x: torch.Tensor, r0: int, r1: int, device) -> torch.Tensor:
    """Rows [r0, r1) of ``x`` padded with zero rows past its end, on
    ``device``."""
    part = x[r0:min(r1, x.shape[0])].to(device)
    pad = (r1 - r0) - part.shape[0]
    if pad == 0:
        return part.contiguous()
    return torch.cat([part, part.new_zeros((pad,) + tuple(x.shape[1:]))])


@dataclasses.dataclass(frozen=True, repr=False)
class EmdIndex:
    """Immutable handle over a corpus placed on its device, or over this
    rank's shard of it on a mesh. Construct via :meth:`build`.

    ``corpus`` is the placed corpus; on a mesh it is the corpus as given
    (its rows are the queries of :meth:`all_pairs`), and the rank's
    shard is on the mesh's device."""
    corpus: Corpus
    config: EngineConfig
    _source: Any = None
    _tuned: dict = dataclasses.field(default_factory=dict)
    _mesh: Mesh | None = None
    _local: Corpus | None = None

    def __repr__(self) -> str:
        c = self.corpus
        where = (f"device={c.device}" if self._mesh is None
                 else f"mesh={self._mesh.shape}, device={self._mesh.device}")
        return (f"EmdIndex(n={c.n}, hmax={c.hmax}, v={c.v}, m={c.m}, "
                f"method={self.config.method!r}, "
                f"backend={self.config.backend!r}, {where})")

    @classmethod
    def build(cls, corpus: Corpus, config: EngineConfig | None = None,
              device=None, *, mesh=None, source=None) -> "EmdIndex":
        """Place ``corpus`` on ``device`` (default ``"cuda"``). Without a
        CUDA device the caller must ask for ``device="cpu"``, which runs
        the kernels' plain PyTorch versions.

        When the config's cascade names a sublinear candidate source, its
        index is built here from ``corpus`` (the host-side fit runs once
        per build) and placed on ``device`` beside the corpus. ``source``
        injects an already-built source instead (a snapshot restore); it
        must match ``config.source_spec``.

        ``mesh``: the distributed backend's (data, model) mesh
        (``launch.mesh.make_test_mesh``); without one, a 1 x 1 mesh on
        ``device`` that holds no process group (NCCL on a card, gloo on
        the CPU, neither initialized). Every rank calls
        ``build`` with the same corpus; the rows must split over
        ``model`` once padded to ``config.pad_multiple``.

        The kernels' tiles are resolved here, once, through
        ``repro_torch.kernels.autotune.resolve_config``: explicit
        ``block_*`` knobs must fit every launch the index plans (else
        ``ValueError``); with ``config.autotune != "off"`` the knobs left
        at None take the cached winners (``"cached"``) or the winners of a
        timed sweep of the admissible tiles on the card (``"force"``). The
        picks are on :attr:`tuned_blocks`, the resolved config on
        ``config``."""
        config = EngineConfig() if config is None else config
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a repro_torch.launch.mesh.Mesh, "
                             f"got {type(mesh).__name__}")
        if mesh is not None and config.backend != "distributed":
            raise ValueError(f"mesh= is for backend='distributed'; this "
                             f"config's backend is {config.backend!r}")
        if device is None and mesh is None:
            if not torch.cuda.is_available():
                raise RuntimeError("EmdIndex.build places the index on "
                                   "'cuda' by default and no CUDA device is "
                                   "available; pass device='cpu' to run on "
                                   "the CPU")
            device = "cuda"
        if config.backend == "distributed":
            return cls._build_distributed(corpus, config, device, mesh,
                                          source)
        from repro_torch.kernels import autotune
        placed = corpus.to(device)
        config, tuned = autotune.resolve_config(placed, config)
        return cls(corpus=placed, config=config,
                   _source=_placed_source(config, corpus, source, device),
                   _tuned=tuned)

    @classmethod
    def _build_distributed(cls, corpus, config, device, mesh, source):
        from repro_torch.kernels import autotune, partition
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch.search import padded_rows
        if mesh is None:
            backend = "nccl" if torch.device(device).type == "cuda" \
                else "gloo"
            mesh = mesh_mod.make_test_mesh(1, 1, backend=backend,
                                           device=device)
        elif device is not None and torch.device(device).type != \
                mesh.device.type:
            raise ValueError(f"device {device!r} is not the mesh's "
                             f"{mesh.device}")
        n_pad = padded_rows(corpus.n, config.pad_multiple)
        parts = mesh.size("model")
        if not partition.rows_shardable(mesh, n_pad):
            raise ValueError(
                f"the corpus's {n_pad} rows (padded to pad_multiple="
                f"{config.pad_multiple}) do not split over the mesh's "
                f"{parts} model ranks")
        r0, r1 = partition.axis_slice(mesh, "model", n_pad)
        dev = mesh.device
        local = Corpus(ids=_row_shard(corpus.ids, r0, r1, dev),
                       w=_row_shard(corpus.w, r0, r1, dev),
                       coords=corpus.coords.to(dev))
        config, tuned = autotune.resolve_config(local, config)
        return cls(corpus=corpus, config=config,
                   _source=_placed_source(config, corpus, source, dev),
                   _tuned=tuned, _mesh=mesh, _local=local)

    @property
    def n(self) -> int:
        """Number of database histograms."""
        return self.corpus.n

    @property
    def mesh(self) -> Mesh | None:
        """The (data, model) mesh of the distributed backend, else None."""
        return self._mesh

    @property
    def device(self) -> torch.device:
        """Where the index's tensors (on a mesh: this rank's shard) live."""
        return self.corpus.device if self._mesh is None else self._mesh.device

    @property
    def tuned_blocks(self) -> dict:
        """``{family: {knob: tile}}`` the autotuner applied at build (empty
        with ``autotune="off"`` or when every pick missed)."""
        return dict(self._tuned)

    @property
    def source(self):
        """The built candidate source feeding cascade stage 1 (``None``
        when the config's cascade is unsourced or full-scan)."""
        return self._source

    def _check_queries(self, q_ids, q_w):
        """Validate query input and bring it to a ``(nq, h)`` batch on the
        index's device; returns (ids, w, was_single)."""
        device = self.device
        q_ids = _to_tensor(q_ids, None, device)
        q_w = _to_tensor(q_w, torch.float32, device)
        if q_ids.dim() not in (1, 2) or q_ids.shape != q_w.shape:
            raise ValueError(f"expected matching (h,) or (nq, h) queries, got "
                             f"ids {tuple(q_ids.shape)} / w "
                             f"{tuple(q_w.shape)}")
        if q_ids.dtype.is_floating_point or q_ids.dtype == torch.bool:
            raise ValueError(f"query ids must be integers, got {q_ids.dtype}")
        if q_ids.numel() and not (0 <= int(q_ids.min())
                                  and int(q_ids.max()) < self.corpus.v):
            raise ValueError(f"query ids must lie in [0, {self.corpus.v})")
        single = q_ids.dim() == 1
        if single:
            q_ids, q_w = q_ids[None], q_w[None]
        return q_ids.contiguous(), q_w.contiguous(), single

    def _run_dist_step(self, step, qi, qw, *extra):
        """Run a mesh step (``launch/search.py``) on a query batch padded
        to the ``data`` size: this rank passes its shards and its queries'
        slice, and gets every query's rows back (pad queries still
        attached: callers cut ``[:nq]``). ``extra`` (a source's tables)
        follows the queries."""
        from repro_torch.launch.search import SEARCH_PLAN, shard
        pad = (0, 0, 0, -qi.shape[0] % self._mesh.size("data"))
        qi, qw = (shard(self._mesh, F.pad(x, pad), SEARCH_PLAN[name])
                  for x, name in ((qi, "q_ids"), (qw, "q_w")))
        p = self._local
        return step(p.ids, p.w, p.coords, qi, qw, *extra)

    def _scores_step(self, **changes):
        from repro_torch.launch.search import make_scores_step
        return make_scores_step(mesh=self._mesh,
                                **dict(self.config.dist_step_kwargs(),
                                       **changes))

    def scores(self, q_ids, q_w) -> torch.Tensor:
        """Directional bound of every database row vs the query/queries:
        ``(h,)`` -> ``(n,)`` through the single-query engine, ``(nq, h)``
        -> ``(nq, n)`` through ``config.batch_engine``. Lower = more
        similar. On a mesh a single query is a batch of one."""
        qi, qw, single = self._check_queries(q_ids, q_w)
        if self._mesh is not None:
            s = self._run_dist_step(self._scores_step(), qi, qw)
            s = s[:qi.shape[0], :self.n]
            return s[0] if single else s
        kw = dict(symmetric=self.config.symmetric,
                  **self.config.score_kwargs())
        if single:
            return retrieval.query_scores(self.corpus, qi[0], qw[0], **kw)
        return retrieval.batch_scores(self.corpus, qi, qw,
                                      engine=self.config.batch_engine, **kw)

    def search(self, q_ids, q_w, top_l: int | None = None, *,
               cascade=None):
        """(scores, indices) of the top-l most similar database rows,
        ascending, lowest index first among ties; ``(top_l,)`` each for a
        single query, ``(nq, top_l)`` for a batch. ``top_l`` defaults to
        ``config.top_l``.

        ``cascade`` (a ``CascadeSpec`` or preset name, defaulting to
        ``config.cascade``) routes the search through the prune-and-rescore
        ladder instead of full-corpus scoring: the scores come from the
        cascade's rescorer, the candidates only from rows that survived
        every pruning stage."""
        top_l = self.config.top_l if top_l is None else top_l
        cascade = self.config.cascade if cascade is None else cascade
        if cascade is None and self._mesh is not None:
            from repro_torch.launch.search import make_search_step
            if not 1 <= top_l <= self.n:
                raise ValueError(f"top_l must be in [1, {self.n}], got "
                                 f"{top_l}")
            qi, qw, single = self._check_queries(q_ids, q_w)
            kw = self.config.dist_step_kwargs()
            step = make_search_step(kw.pop("iters"), top_l, self.n,
                                    mesh=self._mesh, **kw)
            s, i = (x[:qi.shape[0]]
                    for x in self._run_dist_step(step, qi, qw))
            return (s[0], i[0]) if single else (s, i)
        if cascade is None:
            return retrieval.top_l_smallest(self.scores(q_ids, q_w), top_l)
        if self.config.symmetric:
            raise ValueError(
                "cascade search scores directionally; this index is "
                "configured symmetric=True (the rule EngineConfig enforces "
                "for a cascade in the config)")
        qi, qw, single = self._check_queries(q_ids, q_w)
        source = self._source if resolve_spec(cascade).sourced else None
        if self._mesh is not None:
            from repro_torch.launch.search import make_cascade_search_step
            step = make_cascade_search_step(
                cascade, top_l, self.n, topk_blocks=self._mesh.size("model"),
                mesh=self._mesh, **self.config.cascade_step_kwargs())
            tables = () if source is None else source.leaves()
            scores, idx = (x[:qi.shape[0]] for x in
                           self._run_dist_step(step, qi, qw, *tables))
        else:
            res = cascade_search(self.corpus, qi, qw, cascade, top_l,
                                 engine=self.config.batch_engine,
                                 source=source,
                                 **self.config.cascade_knobs())
            scores, idx = res.scores, res.indices
        if single:
            return scores[0], idx[0]
        return scores, idx

    def all_pairs(self) -> torch.Tensor:
        """n x n symmetric score matrix over the corpus (the paper's
        evaluation mode; feed to :meth:`precision_at_l`), scored in chunks
        of corpus rows and symmetrized in place. On a mesh each chunk of
        rows is a query batch of the directional scores step."""
        if self._mesh is None:
            return retrieval.all_pairs_scores(
                self.corpus, engine=self.config.batch_engine,
                **self.config.score_kwargs())
        step = self._scores_step(symmetric=False)
        n = self.n
        chunk = retrieval.all_pairs_chunk(
            self._local, self.config.score_kwargs()["use_kernels"])
        asym = torch.empty((n, n), dtype=torch.float32, device=self.device)
        for s in range(0, n, chunk):
            qi, qw = (x[s:s + chunk].to(self.device)
                      for x in (self.corpus.ids, self.corpus.w))
            asym[s:s + chunk] = self._run_dist_step(step, qi, qw)[
                :qi.shape[0], :n]
        return lc.symmetric_scores(asym)

    def _matrix(self, scores) -> torch.Tensor:
        return (self.all_pairs() if scores is None
                else _to_tensor(scores, None, self.device))

    def precision_at_l(self, labels, top_l: int | None = None, *,
                       scores=None) -> float:
        """Corpus-as-queries precision@top-l (paper Section 6): the
        fraction of each row's top-l neighbours, self excluded, that share
        its label. ``scores``: a precomputed n x n matrix (e.g. one
        ``all_pairs()`` shared across several top-l); defaults to scoring
        the corpus with this index's configuration."""
        top_l = self.config.top_l if top_l is None else top_l
        return retrieval.precision_at_l(self._matrix(scores), labels, top_l)

    def recall_at_l(self, other_scores, top_l: int | None = None, *,
                    scores=None) -> float:
        """Agreement with a reference ranking: the fraction of
        ``other_scores``' top-l neighbours (per corpus row, self excluded)
        that this index's scoring also retrieves. ``other_scores``: the
        reference n x n matrix (exact EMD, a full ACT run, ...);
        ``scores``: this index's precomputed matrix, by default
        ``all_pairs()``."""
        top_l = self.config.top_l if top_l is None else top_l
        return retrieval.recall_at_l(
            self._matrix(scores),
            _to_tensor(other_scores, None, self.device), top_l,
            exclude_self=True)

    def with_config(self, **changes) -> "EmdIndex":
        """This index's corpus, already placed, under a config with
        ``changes`` applied (``dataclasses.replace``). An already-built
        candidate source is reused when the new config keeps the same
        source spec (the host-side fit does not rerun for an unrelated knob
        change). On a mesh the index is built again on the same mesh."""
        config = dataclasses.replace(self.config, **changes)
        reuse = (self._source if self._source is not None
                 and config.source_spec == self._source.spec else None)
        if self._mesh is not None or config.backend == "distributed":
            mesh = self._mesh if config.backend == "distributed" else None
            return EmdIndex.build(self.corpus, config, self.device,
                                  mesh=mesh, source=reuse)
        return EmdIndex(corpus=self.corpus, config=config,
                        _source=_placed_source(config, self.corpus, reuse,
                                               self.corpus.device))
