"""Engine configuration of the port's ``EmdIndex``.

``EngineConfig`` keeps the JAX package's field names, so a configuration
reads the same in both packages. The JAX backend ``pallas`` is this
package's ``cuda`` and raises ``ValueError`` saying so.

The tile knobs ``block_v`` / ``block_h`` / ``block_n`` default to None
here, where the JAX package's default is 256: None leaves each kernel on
its own default tile (a tile on the card means something else than a
TPU tile; ``kernels/ops.py`` says what each knob tiles). The snapshot
codec (``serving/lifecycle.py``) writes None as the JAX package's 256.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cascade.spec import CascadeSpec, resolve_spec
from repro_torch.core.precision import POLICIES
from repro_torch.core.retrieval import METHODS
from repro_torch.launch.search import DEFAULT_ROW_PAD_MULTIPLE

#: ``reference`` runs plain PyTorch ops; ``cuda`` the hand-written kernels
#: (the counterpart of the JAX package's ``pallas``); ``distributed`` the
#: kernels on the shards of a (data, model) mesh (``launch/search.py``).
BACKENDS = ("reference", "cuda", "distributed")

#: JAX ``EngineConfig`` values this package names otherwise.
_UNPORTED_VALUES = {
    "backend": ("pallas",),
}

#: How ``EmdIndex.scores`` scores a batch.
BATCH_ENGINES = ("batched", "scan")

#: The kernels' tile knobs.
TILE_KNOBS = ("block_v", "block_h", "block_n")

#: The autotune policies (``kernels/autotune``).
AUTOTUNE_MODES = ("off", "cached", "force")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen description of how an :class:`~repro_torch.api.EmdIndex`
    scores.

    method:    a ``retrieval.METHODS`` key: ``act`` (LC-ACT-k), ``rwmd``
               (LC-RWMD, db -> query), ``rwmd_rev``, ``omr``, ``ict``,
               ``bow`` or ``wcd``.
    iters:     LC-ACT Phase-2 rounds (``k = iters + 1``; ignored by the
               other methods).
    backend:   ``cuda`` (default; the CUDA kernels, or their plain versions
               on an index built on the CPU) or ``reference`` (PyTorch ops).
               The JAX package's ``pallas`` is ``cuda`` here;
               ``distributed`` runs the kernels on the shards of a
               (data, model) mesh (``EmdIndex.build(..., mesh=)``):
               queries over ``data``, corpus rows and, where it divides,
               the vocabulary over ``model``.
    top_l:     default neighbour count for ``EmdIndex.search``.
    block_q:   queries gathered and poured per Phase-2 block.
    precision: ``f32``, ``bf16`` (bfloat16 handoff ladders, float32 matmul
               and accumulators) or ``bf16_agg`` (bfloat16 handoffs and
               matmul operands, float32 accumulators). It applies to the
               batched engines and the cascade; a single query runs float32
               (the single-query engines are the full-precision oracle).
    symmetric: score the paper's symmetric measure, the max of both
               directions (a method with a reverse direction: rwmd or
               rwmd_rev; bow and wcd are symmetric already).
    batch_engine: how ``EmdIndex.scores`` scores a batch: ``batched``
               (default; Phase 1 once for the whole batch) or ``scan`` (a
               loop of the single-query engine, bitwise equal to scoring
               each query alone; for verification). A single query always
               takes the single-query engine.
    cascade:   ``None`` (full-corpus search), a ``CascadeSpec`` or a preset
               name of ``repro_torch.cascade.CASCADES``: ``search`` then
               runs the prune-and-rescore ladder.
    block_v/block_h/block_n: the CUDA kernels' tiles: K1's vocabulary
               rows a block and valid bins a tile, and the rows (warps) a
               block of the fused K2 and of K3's and K4's corpus-row
               entries (``kernels/ops.py``). None (default): each kernel's
               own default tile. No tile changes a score; a value no
               kernel can take raises here, one a planned launch cannot
               take at ``EmdIndex.build``. An explicit value always wins
               over an autotuned pick.
    rev_block: row block of the reverse (rwmd_rev) reference scorer.
    pad_multiple: the distributed backend pads the corpus rows to a
               multiple of this (zero-weight rows, masked before any top-l)
               so that they split over the mesh's ``model`` axis.
    autotune:  tile policy applied at ``EmdIndex.build``
               (``repro_torch.kernels.autotune``): ``off`` (default: the
               knobs as given), ``cached`` (the ``tune_cache`` winner of
               each planned launch; a miss keeps the default; never times)
               or ``force`` (time the admissible tiles on the card now and
               overwrite the cache). Only knobs left at None are replaced.
    tune_cache: path of the ``TuneCache`` JSON file behind ``autotune``
               (None: in memory only).
    """
    method: str = "act"
    iters: int = 1
    backend: str = "cuda"
    top_l: int = 16
    block_q: int = 8
    precision: str = "f32"
    symmetric: bool = False
    batch_engine: str = "batched"
    block_v: int | None = None
    block_h: int | None = None
    block_n: int | None = None
    rev_block: int = 256
    pad_multiple: int = DEFAULT_ROW_PAD_MULTIPLE
    cascade: CascadeSpec | str | None = None
    autotune: str = "off"
    tune_cache: str | None = None

    def __post_init__(self) -> None:
        if self.cascade is not None and self.symmetric:
            raise ValueError("cascade search scores directionally; "
                             "symmetric=True is not supported with a "
                             "cascade")
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value in _UNPORTED_VALUES.get(f.name, ()):
                raise ValueError(f"EngineConfig.{f.name}={value!r} is not "
                                 "yet ported (the kernels' backend is "
                                 "'cuda' here)")
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; one of "
                             f"{sorted(METHODS)}")
        spec = METHODS[self.method]
        if self.symmetric and not spec.symmetric and spec.reverse is None:
            raise ValueError(
                f"method {self.method!r} has no reverse direction; "
                "symmetric=True needs one (use method='rwmd')")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of "
                             f"{BACKENDS}")
        if self.batch_engine not in BATCH_ENGINES:
            raise ValueError(f"unknown batch_engine {self.batch_engine!r}; "
                             f"one of {BATCH_ENGINES}")
        if self.precision not in POLICIES:
            raise ValueError(f"unknown precision policy {self.precision!r}; "
                             f"one of {sorted(POLICIES)}")
        if self.iters < 0:
            raise ValueError(f"iters must be >= 0, got {self.iters}")
        if self.top_l < 1:
            raise ValueError(f"top_l must be >= 1, got {self.top_l}")
        if self.block_q < 1:
            raise ValueError(f"block_q must be >= 1, got {self.block_q}")
        if self.rev_block < 1:
            raise ValueError(f"rev_block must be >= 1, got {self.rev_block}")
        if self.pad_multiple < 1:
            raise ValueError(f"pad_multiple must be >= 1, got "
                             f"{self.pad_multiple}")
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(f"unknown autotune mode {self.autotune!r}; "
                             f"one of {AUTOTUNE_MODES}")
        self._check_tiles()
        if self.cascade is not None:
            cspec = resolve_spec(self.cascade)   # raises on unknown preset
            if self.backend == "distributed":
                from repro_torch.cascade import rescore
                if not rescore.resolve(cspec.rescorer).jittable:
                    raise ValueError(
                        f"cascade rescorer {cspec.rescorer!r} runs on the "
                        "host; the distributed backend needs a device "
                        "rescorer (act/ict/sinkhorn/...)")
                if cspec.sourced and cspec.source.width is None:
                    raise ValueError(
                        "the distributed cascade needs a candidate source "
                        "with an explicit capacity (bucket_cap/leaf_cap) so "
                        "its tables have fixed shapes; "
                        f"{cspec.source.describe()} sizes to the data")

    def _check_tiles(self) -> None:
        """Each knob set must be an int >= 1 that at least one kernel
        family taking it can build (``analysis.smem.check_tiles``, whatever
        the shape)."""
        from repro_torch.analysis import smem
        from repro_torch.kernels.autotune import FAMILY_KNOBS
        for knob in TILE_KNOBS:
            value = getattr(self, knob)
            if value is None:
                continue
            if isinstance(value, bool) or not isinstance(value, int) \
                    or value < 1:
                raise ValueError(f"EngineConfig.{knob} must be None or an "
                                 f"int >= 1, got {value!r}")
            reasons = []
            for family, knobs in FAMILY_KNOBS.items():
                names = [k for k, _ in knobs]
                if knob not in names:
                    continue
                tiles = {k: getattr(self, k) for k in names
                         if getattr(self, k) is not None}
                bad = smem.check_tiles(family, tiles)
                if not bad:
                    break
                reasons.append(f"{family}: {bad[0].message}")
            else:
                raise ValueError(f"EngineConfig.{knob}={value} is a tile no "
                                 f"kernel takes: " + "; ".join(reasons))

    @property
    def spec(self):
        """The typed :class:`~repro_torch.core.retrieval.MethodSpec`."""
        return METHODS[self.method]

    @property
    def cascade_spec(self) -> CascadeSpec | None:
        """The resolved :class:`~repro_torch.cascade.CascadeSpec` (preset
        names looked up in ``CASCADES``), or ``None``."""
        return None if self.cascade is None else resolve_spec(self.cascade)

    @property
    def source_spec(self):
        """The cascade's candidate-source spec (``repro_torch.candidates``),
        or ``None`` when unsourced or without a cascade: the build
        parameters ``EmdIndex.build`` builds the stage-1 index from."""
        cspec = self.cascade_spec
        return None if cspec is None else cspec.source

    @property
    def effective_iters(self) -> int:
        """Phase-2 rounds actually run (0 for methods other than act)."""
        return self.iters if self.spec.uses_iters else 0

    def _kernel_backend(self) -> bool:
        """True when this config runs the kernels: the ``cuda`` backend,
        or the distributed backend's batched engine (the scan engine
        replays the single-query engines with the kernels off, as in the
        JAX package)."""
        return (self.backend == "cuda"
                or (self.backend == "distributed"
                    and self.batch_engine == "batched"))

    def score_kwargs(self) -> dict:
        """Keyword arguments of ``retrieval.query_scores`` and
        ``retrieval.batch_scores``."""
        return dict(method=self.method, iters=self.effective_iters,
                    use_kernels=(self._kernel_backend()
                                 and self.spec.supports_kernels),
                    block_q=self.block_q, precision=self.precision,
                    block_v=self.block_v, block_h=self.block_h,
                    block_n=self.block_n, rev_block=self.rev_block)

    def cascade_knobs(self) -> dict:
        """Keyword arguments of ``cascade.cascade_search``: those of
        ``score_kwargs`` without the method (the cascade spec carries its
        own stage methods and iters). ``use_kernels`` follows the backend
        alone: on ``cuda`` it reaches every layer of the ladder, the
        Phase-1/2 kernels of stage 1 and the candidate kernels of the
        compacted stages and device rescorers; methods without kernels
        ignore it."""
        kw = self.score_kwargs()
        del kw["method"], kw["iters"]
        kw["use_kernels"] = self._kernel_backend()
        return kw

    def dist_step_kwargs(self) -> dict:
        """Keyword arguments of ``launch.search.make_scores_step``: those of
        ``score_kwargs``, the symmetric flag and the mesh engine (``dist``
        for the batched engine, ``scan`` for the scan engine)."""
        return dict(self.score_kwargs(), symmetric=self.symmetric,
                    engine=("dist" if self.batch_engine == "batched"
                            else "scan"))

    def cascade_step_kwargs(self) -> dict:
        """Keyword arguments of ``launch.search.make_cascade_search_step``:
        ``cascade_knobs`` and the mesh engine."""
        return dict(self.cascade_knobs(),
                    engine=("dist" if self.batch_engine == "batched"
                            else "scan"))
