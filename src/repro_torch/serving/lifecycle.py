"""Crash-safe index lifecycle: snapshot / restore / recover.

A serving snapshot is one checkpoint step written through
``checkpoint/store``'s atomic manifest protocol (tmp + rename, SHA-256 per
leaf), keyed by the server's GENERATION counter, holding:

* the corpus tables ``ids``, ``w``, ``coords``: nothing else is needed to
  rebuild every engine;
* the corpus manifest: the external ``doc_ids`` row map and the next id to
  assign, so append/delete history survives a restart;
* the primary tier's built candidate source, as ``source/0``,
  ``source/1``, ... in its ``leaves()`` order, so a restore skips the
  host-side fit;
* the frozen ``EngineConfig`` (cascade spec and source spec included),
  JSON-encoded in the checkpoint's ``extra`` block.

The format is the JAX package's (``repro/serving/lifecycle.py``), so a
snapshot written by either package restores in the other: the store's
files are the same bytes, the source leaves come in the same order, and
the config codec writes the JAX package's backend names (the port's
``cuda`` is the JAX package's ``pallas``).

``restore_server`` rebuilds a serving runtime from the newest snapshot
that passes integrity verification: a corrupt or torn newest snapshot
(``CheckpointCorrupt``) falls back to the previous generation instead of
refusing to serve.

On a mesh (``EmdServer`` over the distributed backend, serving/server.py)
the leader alone writes a snapshot: it holds the whole corpus, as every
rank does. ``restore_server(mesh=)`` is the recovery of a new world: every
rank calls it on the same directory, the leader picks the generation and
sends its number before any other rank reads a leaf (ranks that each
walked the directory could disagree while a save is in progress), and
every rank builds the index on the mesh from that generation's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.api.config import TILE_KNOBS, EngineConfig
from repro_torch.api.index import EmdIndex
from repro_torch.candidates import SOURCES, SourceSpec
from repro_torch.cascade.spec import CascadeSpec, CascadeStage
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import CheckpointCorrupt
from repro_torch.core.lc import Corpus
from repro_torch.launch.mesh import Mesh
from repro_torch.serving import control as ctl
from repro_torch.serving.policy import ServingPolicy
from repro_torch.serving.server import EmdServer

#: Leaf names of a serving snapshot (the ``like`` tree for store.restore is
#: reconstructed from the manifest, so restore needs no prior shapes).
SNAPSHOT_LEAVES = ("ids", "w", "coords", "doc_ids")

#: The port's backend names as the JAX package writes them.
_BACKEND_ON_DISK = {"cuda": "pallas", "reference": "reference",
                    "distributed": "distributed"}

#: The JAX package's default of each tile knob, which the codec writes for
#: the port's None (each kernel's own tile) and reads back as None.
_JAX_TILE_DEFAULT = 256


# ------------------------------------------------------------- config codec
def config_to_dict(config: EngineConfig) -> dict:
    """JSON-encodable dict in the JAX package's codec, round-tripping
    through :func:`config_from_dict` (a CascadeSpec encoded structurally;
    preset names stay strings)."""
    d = {f.name: getattr(config, f.name)
         for f in dataclasses.fields(config)}
    d["backend"] = _BACKEND_ON_DISK[d["backend"]]
    for knob in TILE_KNOBS:
        if d[knob] is None:
            d[knob] = _JAX_TILE_DEFAULT
    c = d["cascade"]
    if isinstance(c, CascadeSpec):
        source = None
        if isinstance(c.source, SourceSpec):
            source = dict(kind=c.source.kind,
                          **dataclasses.asdict(c.source))
        d["cascade"] = {
            "stages": [{"method": s.method, "budget": s.budget,
                        "iters": s.iters} for s in c.stages],
            "rescorer": c.rescorer,
            "rescorer_iters": c.rescorer_iters,
            "source": source,
        }
    return d


def config_from_dict(d: dict) -> EngineConfig:
    d = dict(d)
    on_disk = {v: k for k, v in _BACKEND_ON_DISK.items()}
    d["backend"] = on_disk.get(d["backend"], d["backend"])
    for knob in TILE_KNOBS:
        if d.get(knob) == _JAX_TILE_DEFAULT:
            d[knob] = None
    c = d.get("cascade")
    if isinstance(c, dict):
        source = c.get("source")
        if isinstance(source, dict):
            source = dict(source)
            source = SOURCES[source.pop("kind")](**source)
        d["cascade"] = CascadeSpec(
            stages=tuple(CascadeStage(**s) for s in c["stages"]),
            rescorer=c["rescorer"],
            rescorer_iters=c["rescorer_iters"],
            source=source)
    return EngineConfig(**d)


# ---------------------------------------------------------------- snapshot
def snapshot(server: EmdServer, ckpt_dir: str) -> str | None:
    """Write the server's CURRENT generation as checkpoint step
    ``generation`` under ``ckpt_dir``; returns the snapshot path.
    Atomic: a crash mid-save leaves the previous snapshot live. On a mesh
    the leader writes it and a follower writes nothing (None)."""
    if not server.is_leader:
        return None
    gen = server._gen
    tree = {"ids": gen.corpus.ids, "w": gen.corpus.w,
            "coords": gen.corpus.coords, "doc_ids": gen.doc_ids}
    # The primary tier's built candidate-source state checkpoints too:
    # restore then skips the host-side index fit.
    source_leaves = 0
    primary = next((t.index for t in gen.tiers
                    if t.tier.name == "primary"), None)
    if primary is not None and primary.source is not None:
        leaves = primary.source.leaves()
        for i, leaf in enumerate(leaves):
            tree[f"source/{i}"] = leaf
        source_leaves = len(leaves)
    extra = {
        "kind": "emd-serving-snapshot",
        "generation": gen.gen,
        "next_doc_id": server._next_doc_id,
        "config": config_to_dict(server.config),
        # The tiles exactly (the config codec writes None as the JAX
        # package's 256, and reads 256 back as None).
        "tiles": {k: getattr(server.config, k) for k in TILE_KNOBS},
        "corpus_manifest": {"n": gen.corpus.n, "hmax": gen.corpus.hmax,
                            "v": gen.corpus.v, "m": gen.corpus.m},
        "source_leaves": source_leaves,
    }
    return store.save(ckpt_dir, gen.gen, tree, extra=extra)


@dataclasses.dataclass(frozen=True)
class RestoredSnapshot:
    """One verified snapshot, ready to build a server from (tables on the
    CPU)."""
    corpus: Corpus
    doc_ids: np.ndarray
    config: EngineConfig
    generation: int
    next_doc_id: int
    #: The built candidate source checkpointed with the primary tier,
    #: ``None`` for unsourced configs: feed it to
    #: ``EmdIndex.build(source=...)`` so restore skips the host-side fit.
    source: Any = None


def _like_from_manifest(manifest: dict) -> dict[str, Any]:
    """Zero-storage tensors of each leaf's stored shape and dtype (bfloat16
    through torch: no ``ml_dtypes``), the restore targets."""
    like = {}
    n_src = int(manifest.get("extra", {}).get("source_leaves", 0))
    names = SNAPSHOT_LEAVES + tuple(f"source/{i}" for i in range(n_src))
    for name in names:
        try:
            meta = manifest["leaves"][name]
            dtype = store.TORCH_DTYPES[meta["dtype"]]
        except KeyError as e:
            raise CheckpointCorrupt(
                f"serving snapshot missing leaf {name!r} or its dtype"
            ) from e
        like[name] = torch.empty((), dtype=dtype).expand(meta["shape"])
    return like


def restore_snapshot(ckpt_dir: str,
                     generation: int | None = None) -> RestoredSnapshot:
    """Load + verify snapshot ``generation`` (default: newest complete).
    Raises :class:`~repro_torch.checkpoint.store.CheckpointCorrupt` on torn
    or corrupt data; see :func:`restore_latest` for the falling-back
    variant."""
    if generation is None:
        generation = store.latest_step(ckpt_dir)
        if generation is None:
            raise FileNotFoundError(
                f"no complete serving snapshot under {ckpt_dir}")
    manifest = store.load_manifest(ckpt_dir, generation)
    extra = manifest.get("extra", {})
    if extra.get("kind") != "emd-serving-snapshot":
        raise CheckpointCorrupt(
            f"step {generation} under {ckpt_dir} is not a serving "
            f"snapshot (kind={extra.get('kind')!r})")
    tree = store.restore(ckpt_dir, generation,
                         _like_from_manifest(manifest))
    config = config_from_dict(extra["config"])
    if "tiles" in extra:
        config = dataclasses.replace(config, **extra["tiles"])
    source = None
    n_src = int(extra.get("source_leaves", 0))
    if n_src:
        src_spec = config.source_spec
        if src_spec is None:
            raise CheckpointCorrupt(
                f"step {generation} carries {n_src} candidate-source "
                "leaves but its config declares no source")
        source = src_spec.wrap(tuple(tree[f"source/{i}"]
                                     for i in range(n_src)))
    return RestoredSnapshot(
        corpus=Corpus(ids=tree["ids"], w=tree["w"], coords=tree["coords"]),
        doc_ids=tree["doc_ids"].numpy(),
        config=config,
        generation=generation,
        next_doc_id=int(extra["next_doc_id"]),
        source=source)


def restore_latest(ckpt_dir: str) -> RestoredSnapshot:
    """Newest snapshot that passes FULL integrity verification, walking
    backwards over generations past any corrupt/torn ones (a crash
    mid-save, or chaos-injected corruption, costs at most the mutations
    since the previous snapshot)."""
    failures = []
    for generation in reversed(store.steps(ckpt_dir)):
        try:
            return restore_snapshot(ckpt_dir, generation)
        except CheckpointCorrupt as e:
            failures.append(f"gen {generation}: {e}")
    raise CheckpointCorrupt(
        f"no intact serving snapshot under {ckpt_dir}"
        + (": " + "; ".join(failures) if failures else ""))


def restore_server(ckpt_dir: str, policy: ServingPolicy | None = None, *,
                   generation: int | None = None, mesh=None,
                   launch_hook=None, device=None) -> EmdServer:
    """Snapshot -> ready-to-run :class:`EmdServer` (the caller still
    ``await start()``s it) on ``device`` (default ``"cuda"``, as
    ``EmdIndex.build``). ``generation=None`` takes the newest INTACT
    snapshot (corrupt ones skipped).

    ``mesh`` (a ``launch.mesh.Mesh``, for a snapshot of the distributed
    backend) builds the index on it. In a world of more than one rank
    every rank calls this with its part of a mesh that spans the world;
    the leader picks the generation and the others read the one it
    sends. Then the leader serves and the others ``follow()``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"restore_server(mesh=) takes a "
                         f"repro_torch.launch.mesh.Mesh, got "
                         f"{type(mesh).__name__}")
    control = None if mesh is None else ctl.Control.create(mesh)
    if control is None:
        snap = (restore_latest(ckpt_dir) if generation is None
                else restore_snapshot(ckpt_dir, generation))
    else:
        snap = _restore_together(control, ckpt_dir, generation)
    index = EmdIndex.build(snap.corpus, snap.config, device, mesh=mesh,
                           source=snap.source)
    return EmdServer(index, policy, launch_hook=launch_hook,
                     doc_ids=snap.doc_ids, generation=snap.generation,
                     next_doc_id=snap.next_doc_id, control=control)


def _restore_together(control, ckpt_dir: str,
                      generation: int | None) -> RestoredSnapshot:
    """Every rank's snapshot of the generation the leader picked: the
    leader verifies it (falling back past corrupt ones when
    ``generation`` is None) and sends its number (-1: none), then the
    others read it; a rank that fails fails them all."""
    snap, err = None, None
    if control.is_leader:
        try:
            snap = (restore_latest(ckpt_dir) if generation is None
                    else restore_snapshot(ckpt_dir, generation))
        except (CheckpointCorrupt, FileNotFoundError) as e:
            err = e
        chosen = control.broadcast_int(-1 if snap is None
                                       else snap.generation)
    else:
        chosen = control.broadcast_int(-1)
        if chosen >= 0:
            try:
                snap = restore_snapshot(ckpt_dir, chosen)
            except (CheckpointCorrupt, FileNotFoundError) as e:
                err = e
    statuses = control.statuses(ctl.OK if snap is not None else ctl.FAILED)
    if err is not None:
        raise err
    if chosen < 0 or any(statuses):
        raise CheckpointCorrupt(
            f"restore under {ckpt_dir} failed on world ranks "
            f"{[r for r, s in enumerate(statuses) if s]}"
            + ("" if chosen >= 0 else ": the leader found no intact "
               "snapshot"))
    return snap
