"""Tile autotuner for the port's kernels, on sm_90's budget.

A kernel's tile (``block_v`` / ``block_h`` / ``block_n``) decides whether a
launch fits a block on an SM and how fast it runs; it never decides the
result: a knob may only change which thread or block computes an output,
so every variant is bitwise the default (``kernels/ops.py`` says, per
family, which knobs are safe and why the others are left out). The
counterpart of the JAX package's ``kernels/autotune.py``, with the same
semantics:

* candidate enumeration -- :func:`admissible_configs` sweeps tile
  assignments and keeps only those ``analysis/smem.check_launch`` admits,
  so no timed variant can fail to launch;
* timing -- :func:`tune` builds the admissible variants (one ``nvcc`` each,
  all at once) and runs a paired interleaved tournament on the card
  (``kernels/timing.paired``), and caches the winner in a
  :class:`TuneCache` keyed by (kernel family, shape bucket, dtype), shapes
  bucketed to the next power of two.

``EngineConfig`` threads the policy: ``autotune="off"`` (default: nothing
here runs), ``"cached"`` (apply cached winners, never time; a miss keeps
the defaults), or ``"force"`` (time the admissible variants now and
overwrite the cache; on the card only). An explicit ``block_*`` always
wins: only knobs still at their ``EngineConfig`` default (None: each
family's own default tile) are eligible for a tuned pick
(:func:`resolve_config`).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os

from repro_torch.analysis import smem
from repro_torch.kernels import _build, ops, timing

#: Per kernel family: the (EngineConfig knob, dim it tiles) pairs the
#: tuner sweeps (``ops.TILE_MACROS`` says why a family lacks a knob).
FAMILY_KNOBS: dict[str, tuple[tuple[str, str], ...]] = {
    "dist_topk": (("block_v", "v"), ("block_h", "h")),
    "act_phase2": (("block_n", "n"),),
    "act_phase2_cand": (),
    "cand_pour": (("block_n", "b"),),
    "cand_dist": (("block_n", "b"),),
}

#: Tile candidates per knob: K1's vocabulary rows a block and valid bins a
#: tile, and the rows (warps) a block of the warp-per-row kernels.
CANDIDATE_BLOCKS = {
    "block_v": (64, 128, 256),
    "block_h": (32, 64, 128),
    "block_n": (1, 2, 4, 8, 16, 32),
}

#: Most variants of a family that ``"force"`` builds and times, the first
#: in :func:`admissible_configs`' order (each is one ``nvcc`` process).
MAX_VARIANTS = 8


def _bucket(x: int) -> int:
    """Next power of two >= x (>= 1) -- the shape-bucketing of cache keys."""
    b = 1
    while b < x:
        b *= 2
    return b


def _violations(family: str, dims: dict, tiles: dict,
                budget: smem.Budget = smem.Budget()) -> list:
    """What keeps ``tiles`` from ``family``'s launch at ``dims``: the
    launch's budget (``smem.check_launch``) and the variant's library, all
    of whose kernels must build (``smem.check_tiles``)."""
    return (smem.check_launch(f"autotune:{family}", family,
                              {**dims, **tiles}, budget=budget)
            + smem.check_tiles(family, tiles, budget=budget))


def admissible_configs(family: str, dims: dict, *,
                       budget: smem.Budget = smem.Budget()) -> list[dict]:
    """Every tile assignment for ``family`` at ``dims`` that the budget
    model admits (:func:`_violations`), each once. Deterministic order: the
    family's default tile first (a tournament's incumbent), then the rest
    ascending."""
    knobs = [knob for knob, dim in FAMILY_KNOBS[family] if dim in dims]
    default = tuple(ops.DEFAULT_TILES[family][k] for k in knobs)
    combos = itertools.chain(
        [default],
        itertools.product(*(CANDIDATE_BLOCKS[k] for k in knobs)))
    out, seen = [], set()
    for combo in combos:
        if combo in seen:
            continue
        seen.add(combo)
        cfg = dict(zip(knobs, combo))
        if not _violations(family, dims, cfg, budget):
            out.append(cfg)
    return out


@dataclasses.dataclass
class TuneCache:
    """Winner store: {cache key -> {knob: tile}}. JSON round-trippable so
    a tuning run on the card ships as a file; the JAX package's layout and
    key rule."""
    entries: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def key(family: str, dims: dict, dtype: str = "float32") -> str:
        parts = []
        for k in sorted(dims):
            v = dims[k]
            parts.append(f"{k}={_bucket(v) if isinstance(v, int) else v}")
        return f"{family}|{','.join(parts)}|{dtype}"

    def get(self, family: str, dims: dict,
            dtype: str = "float32") -> dict | None:
        hit = self.entries.get(self.key(family, dims, dtype))
        return dict(hit) if hit is not None else None

    def put(self, family: str, dims: dict, config: dict,
            dtype: str = "float32") -> None:
        self.entries[self.key(family, dims, dtype)] = dict(config)

    def to_json(self) -> str:
        return json.dumps({"version": 1, "entries": self.entries},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TuneCache":
        data = json.loads(text)
        return cls(entries=dict(data.get("entries", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str | None) -> "TuneCache":
        """Empty cache when ``path`` is None or missing: a cold cache is
        the normal first-run state, not an error."""
        if path is None or not os.path.exists(path):
            return cls()
        with open(path) as f:
            return cls.from_json(f.read())


def tournament(configs: list[dict], make_run, reps: int = 5) -> dict:
    """Single-elimination paired timing: the incumbent meets each
    challenger in one interleaved ``paired`` bout; the faster (median of
    per-rep ratios) advances, the incumbent keeps a tie. O(len(configs))
    bouts, drift-robust."""
    best = configs[0]
    best_fn = make_run(best)
    for cfg in configs[1:]:
        fn = make_run(cfg)
        _, _, ratio = timing.paired(best_fn, fn, reps)
        if ratio > 1.0:                        # incumbent slower
            best, best_fn = cfg, fn
    return best


def tune(family: str, dims: dict, make_run, *, cache: TuneCache | None = None,
         mode: str = "cached", dtype: str = "float32", reps: int = 5,
         budget: smem.Budget = smem.Budget(),
         configs: list[dict] | None = None) -> dict | None:
    """Resolve the tile config for one launch shape.

    ``make_run(config) -> zero-arg callable`` builds the timed launch for
    a candidate (only invoked when timing actually happens). Returns the
    winning {knob: tile} dict, or ``None`` when ``mode="off"`` /
    ``mode="cached"`` misses / nothing is admissible. ``"force"`` times
    ``configs``, by default the first :data:`MAX_VARIANTS` admissible
    configs."""
    if mode not in ("off", "cached", "force"):
        raise ValueError(f"unknown autotune mode {mode!r}; "
                         "one of ('off', 'cached', 'force')")
    if mode == "off":
        return None
    if mode == "cached":
        return cache.get(family, dims, dtype) if cache is not None else None
    if configs is None:
        configs = admissible_configs(family, dims,
                                     budget=budget)[:MAX_VARIANTS]
    if not configs:
        return None
    best = tournament(configs, make_run, reps)
    if cache is not None:
        cache.put(family, dims, best, dtype)
    return best


# ------------------------------------------------------------------ index
# EngineConfig resolution: which launches an EmdIndex build will make on
# the kernel path, and what to time them with.

#: Candidate rows a query of a cascade's candidate stage, as planned (the
#: JAX package's).
_PLAN_B = 256


def _engine_plan(corpus, method: str, iters: int, nq: int,
                 b: int | None = None) -> list[tuple[str, dict]]:
    """The (family, dims) launches of ``method``'s batched engine over the
    whole corpus (``b`` None) or of its candidate engine at ``b`` rows a
    query."""
    n, h = corpus.n, corpus.hmax
    iters = iters if method == "act" else 0
    out = []
    k1 = {"act": iters + 1, "rwmd": 1, "omr": 2}
    if method in k1:
        out.append(("dist_topk", dict(nq=nq, v=corpus.v, h=h, m=corpus.m,
                                      k=k1[method])))
    rows = dict(nq=nq, b=n if b is None else b, h=h,
                form="all" if b is None else "cand")
    if method == "act" and iters >= 1 and b is None:
        out.append(("act_phase2", dict(nq=nq, n=n, h=h, iters=iters)))
    elif method in ("act", "rwmd"):
        out.append(("cand_pour", dict(rows, iters=iters, mode="pour")))
    elif method == "omr":
        out.append(("cand_pour", dict(rows, iters=1, mode="omr")))
    elif method in ("rwmd_rev", "ict"):
        out.append(("cand_dist", dict(rows, mode="ict" if method == "ict"
                                      else "rev_min")))
    return out


def index_plan(corpus, config) -> list[tuple[str, dict]]:
    """The (family, dims) launches an ``EmdIndex.build(corpus, config)``
    plans on its kernel path, each once, in resolution order (first pick
    of a shared knob wins): the method's full-corpus engine (K1, the fused
    K2, K3's dump or omr, K4), then with a cascade its unsourced stage 1
    and its candidate stages and rescorer at ``_PLAN_B`` rows a query.
    None on the reference backend (on the distributed backend the corpus is
    the rank's row shard)."""
    if config.backend == "reference":
        return []
    nq = config.block_q
    plan = _engine_plan(corpus, config.method, config.effective_iters, nq)
    spec = config.cascade_spec
    if spec is not None:
        later = spec.stages
        if not spec.sourced:
            plan += _engine_plan(corpus, later[0].method, later[0].iters, nq)
            later = later[1:]
        for stage in later:
            plan += _engine_plan(corpus, stage.method, stage.iters, nq,
                                 _PLAN_B)
        plan += _engine_plan(corpus, spec.rescorer, spec.rescorer_iters, nq,
                             _PLAN_B)
    out = []
    for entry in plan:
        if entry not in out:
            out.append(entry)
    return out


def _runner(family: str, dims: dict, corpus, configs: list[dict]):
    """make_run factory for force-mode timing: the launch at ``dims`` on
    the corpus's own rows (queries spread over the corpus, seeded
    candidate rows), through the wrapper with each candidate tile. The
    variants of ``configs`` are built together before the first is
    timed."""
    import torch

    from repro_torch.core import lc

    nq, n = dims["nq"], corpus.n
    rows = torch.arange(nq, device=corpus.device) * max(1, n // nq) % n
    q_ids, q_w = corpus.ids[rows].contiguous(), corpus.w[rows].contiguous()
    gen = torch.Generator(device=corpus.device).manual_seed(0)
    cand = None
    if dims.get("form", "cand") == "cand" and "b" in dims:
        cand = torch.randint(0, n, (nq, dims["b"]), generator=gen,
                             device=corpus.device)
    if family == "dist_topk":
        coords = corpus.coords
        qcs, qmask, k = coords[q_ids], q_w > 0, dims["k"]

        def launch(cfg):
            return lambda: ops.dist_topk_batched(coords, qcs, qmask, k,
                                                 **cfg)
    elif family == "act_phase2":
        Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w,
                                           dims["iters"] + 1, True)

        def launch(cfg):
            return lambda: ops.act_phase2_gather(corpus.w, corpus.ids, Z, W,
                                                 **cfg)
    elif family == "cand_pour":
        iters = dims["iters"]
        omr = dims["mode"] == "omr"
        Z, W = lc._phase1_batched_dispatch(corpus, q_ids, q_w,
                                           2 if omr else iters + 1, True)

        def launch(cfg):
            if omr:
                W0 = W[..., 0].contiguous()
                return lambda: ops.cand_omr_rows(corpus.ids, corpus.w, cand,
                                                 Z, W0, **cfg)
            return lambda: ops.cand_pour_rows(
                corpus.ids, corpus.w, cand, Z, W if iters else None, iters,
                **cfg)
    else:
        assert family == "cand_dist", family
        handoff = lc.phase1_valid_dist(corpus.coords, q_ids, q_w)
        fn = ops.cand_ict_valid if dims["mode"] == "ict" \
            else ops.cand_rev_min_valid

        def launch(cfg):
            return lambda: fn(corpus.ids, corpus.w, cand, *handoff, **cfg)

    built = []

    def make_run(cfg):
        if not built:
            source = ops.family_source(family, dims.get("form", "cand"))
            _build.build_variants(
                [(source, dict(ops.variant(family, **c))) for c in configs])
            built.append(True)
        return launch(cfg)
    return make_run


def _plan_violations(plan, tiles: dict) -> list[tuple[str, dict, list]]:
    """(family, dims, violations) of every planned launch that takes one
    of ``tiles``' knobs and cannot take its value: a knob is shared (each
    family that takes ``block_n`` gets the same value), so a tile must fit
    every planned launch that takes it."""
    out = []
    for family, dims in plan:
        sub = {k: v for k, v in tiles.items()
               if v is not None and k in dict(FAMILY_KNOBS[family])}
        bad = _violations(family, dims, sub) if sub else []
        if bad:
            out.append((family, dims, bad))
    return out


def _admit(plan, tiles: dict, what: str) -> None:
    """Raise ``ValueError`` naming the family, the tile and the limit it
    breaks if a planned launch cannot take ``tiles``."""
    bad = _plan_violations(plan, tiles)
    if bad:
        family, dims, violations = bad[0]
        raise ValueError(
            f"{what} {tiles} for {family} ({ops.FAMILY_ENTRIES[family][0]}) "
            f"at {dims} is not admitted: "
            + "; ".join(v.message for v in violations))


def resolve_config(corpus, config):
    """Apply the autotune policy to an ``EngineConfig`` at build time, the
    corpus on the index's device.

    Returns ``(config, picks)``: the config with eligible block knobs
    replaced by tuned tiles, and ``{family: {knob: tile}}`` of what was
    applied. A knob is eligible only while it is still at its dataclass
    default (None) -- an explicit ``block_*`` always wins, and must be
    admitted at every planned launch (else ``ValueError``). ``"cached"``
    never times (a miss keeps the defaults; an entry the budget model does
    not admit raises ``ValueError``); ``"force"`` times every planned
    family that has an eligible knob, on the card only, among the tiles
    every planned launch taking the same knobs admits, and persists to
    ``config.tune_cache``."""
    plan = index_plan(corpus, config)
    _admit(plan, {k: getattr(config, k) for k in ("block_v", "block_h",
                                                  "block_n")},
           "EngineConfig tile")
    if config.autotune == "off":
        return config, {}
    if config.autotune == "force" and corpus.device.type != "cuda":
        raise ValueError("autotune='force' times the kernels on the card; "
                         f"this index is on {corpus.device}")
    cache = TuneCache.load(config.tune_cache)
    taken: set[str] = set()
    changes: dict = {}
    picks: dict = {}
    for family, dims in plan:
        eligible = [knob for knob, _ in FAMILY_KNOBS[family]
                    if knob not in taken and getattr(config, knob) is None]
        if not eligible:
            continue
        make_run, configs = None, None
        if config.autotune == "force":
            configs = [c for c in admissible_configs(family, dims)
                       if not _plan_violations(plan, c)][:MAX_VARIANTS]
            make_run = _runner(family, dims, corpus, configs)
        pick = tune(family, dims, make_run, cache=cache,
                    mode=config.autotune, configs=configs)
        if not pick:
            continue
        _admit(plan, pick, "tune cache entry")
        applied = {knob: tile for knob, tile in pick.items()
                   if knob in eligible}
        taken.update(applied)
        changes.update(applied)
        if applied:
            picks[family] = applied
    if config.autotune == "force" and config.tune_cache is not None:
        cache.save(config.tune_cache)
    if changes:
        config = dataclasses.replace(config, **changes)
    return config, picks
