"""``EmdIndex``: build once over a corpus, then score and search query
batches, on one device.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.cascade import cascade_search, resolve_spec
from repro_torch.core import retrieval
from repro_torch.core.lc import Corpus


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


@dataclasses.dataclass(frozen=True, repr=False)
class EmdIndex:
    """Immutable handle over a corpus placed on its device. Construct via
    :meth:`build`."""
    corpus: Corpus
    config: EngineConfig
    _source: Any = None
    _tuned: dict = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:
        c = self.corpus
        return (f"EmdIndex(n={c.n}, hmax={c.hmax}, v={c.v}, m={c.m}, "
                f"method={self.config.method!r}, "
                f"backend={self.config.backend!r}, device={c.device})")

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
        must match ``config.source_spec``. ``mesh`` (the JAX package's
        distributed backend) is not yet ported (ROADMAP Queue 1 item 6).

        The kernels' tiles are resolved here, once, through
        ``repro_torch.kernels.autotune.resolve_config``: explicit
        ``block_*`` knobs must fit every launch the index plans (else
        ``ValueError``); with ``config.autotune != "off"`` the knobs left
        at None take the cached winners (``"cached"``) or the winners of a
        timed sweep of the admissible tiles on the card (``"force"``). The
        picks are on :attr:`tuned_blocks`, the resolved config on
        ``config``."""
        config = EngineConfig() if config is None else config
        if mesh is not None:
            raise ValueError("EmdIndex.build(mesh=...) is not yet ported: "
                             "the mesh is ROADMAP Queue 1 item 6")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("EmdIndex.build places the index on "
                                   "'cuda' by default and no CUDA device is "
                                   "available; pass device='cpu' to run on "
                                   "the CPU")
            device = "cuda"
        from repro_torch.kernels import autotune
        placed = corpus.to(device)
        config, tuned = autotune.resolve_config(placed, config)
        return cls(corpus=placed, config=config,
                   _source=_placed_source(config, corpus, source, device),
                   _tuned=tuned)

    @property
    def n(self) -> int:
        """Number of database histograms."""
        return self.corpus.n

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
        device = self.corpus.device
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

    def scores(self, q_ids, q_w) -> torch.Tensor:
        """Directional bound of every database row vs the query/queries:
        ``(h,)`` -> ``(n,)`` through the single-query engine, ``(nq, h)``
        -> ``(nq, n)`` through ``config.batch_engine``. Lower = more
        similar."""
        qi, qw, single = self._check_queries(q_ids, q_w)
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
        if cascade is None:
            return retrieval.top_l_smallest(self.scores(q_ids, q_w), top_l)
        if self.config.symmetric:
            raise ValueError(
                "cascade search scores directionally; this index is "
                "configured symmetric=True (the rule EngineConfig enforces "
                "for a cascade in the config)")
        qi, qw, single = self._check_queries(q_ids, q_w)
        res = cascade_search(self.corpus, qi, qw, cascade, top_l,
                             engine=self.config.batch_engine,
                             source=(self._source
                                     if resolve_spec(cascade).sourced
                                     else None),
                             **self.config.cascade_knobs())
        if single:
            return res.scores[0], res.indices[0]
        return res.scores, res.indices

    def all_pairs(self) -> torch.Tensor:
        """n x n symmetric score matrix over the corpus (the paper's
        evaluation mode; feed to :meth:`precision_at_l`), scored in chunks
        of corpus rows and symmetrized in place."""
        return retrieval.all_pairs_scores(self.corpus,
                                          engine=self.config.batch_engine,
                                          **self.config.score_kwargs())

    def _matrix(self, scores) -> torch.Tensor:
        return (self.all_pairs() if scores is None
                else _to_tensor(scores, None, self.corpus.device))

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
            _to_tensor(other_scores, None, self.corpus.device), top_l,
            exclude_self=True)

    def with_config(self, **changes) -> "EmdIndex":
        """This index's corpus, already placed, under a config with
        ``changes`` applied (``dataclasses.replace``). An already-built
        candidate source is reused when the new config keeps the same
        source spec (the host-side fit does not rerun for an unrelated knob
        change)."""
        config = dataclasses.replace(self.config, **changes)
        reuse = (self._source if self._source is not None
                 and config.source_spec == self._source.spec else None)
        return EmdIndex(corpus=self.corpus, config=config,
                        _source=_placed_source(config, self.corpus, reuse,
                                               self.corpus.device))
