"""Elastic scaling: move a built index's tables onto another mesh.

Counterpart of the JAX package's ``runtime/elastic.py``. There one
controller re-places its arrays with ``jax.device_put`` under explicit
target shardings; here the mesh is a world of processes, each holding its
own shards, so :func:`reshard_live` is a collective: every rank of the
default group calls it, with its shards under the old mesh (None on a rank
that holds none) and its part of the new mesh (None on a rank outside it).
The plan (``launch/search.py``'s :data:`~repro_torch.launch.search.SEARCH_PLAN`
for the corpus tables) says which mesh axis splits each dim of each table,
in both meshes; it plays the part of JAX's explicit ``shardings=``.

Each rank of the new mesh ends up with the block of each table that the
plan gives its coordinates: bitwise the shard that
``EmdIndex.build(corpus, config, mesh=new_mesh)`` slices from the corpus.
The parts it held already stay where they are; every other part comes
from one rank of the old mesh that holds it, point to point over a gloo
group of the whole world (a rank that rejoins with no rows receives them
all from survivors). The bytes a rank receives, the layout exchange
included, count in ``sharding.annotate.TRAFFIC`` under ``reshard``.

For the LM, :func:`reshard_plan` is the parameters' layout on a mesh, from
the same rule table the mesh train step uses (``sharding/rules.py``), and
:func:`restore_on_mesh` is the elastic event: a checkpoint, written whole
in the JAX package's layout from any mesh or one device (nothing in it
depends on the mesh it came from), read back as each rank's blocks on a
new mesh, ready for ``launch.steps.make_mesh_train_step``. Every rank reads
each leaf it needs whole, one leaf at a time, and keeps its block.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AXES
from repro_torch.sharding import annotate

#: Label of the tables' bytes in ``annotate.TRAFFIC``.
LABEL = "reshard"

#: The dtypes a table may have, by their code in the layout exchange.
_DTYPES = (torch.int32, torch.int64, torch.float32, torch.bfloat16,
           torch.float16, torch.uint8)
_MAX_DIMS = 4


def _layout_model(params_like):
    """The meta-device layout of an ``LM`` or of a mesh training state."""
    from repro_torch.models import model as M
    if isinstance(params_like, M.LM):
        return M.init(params_like.cfg, device="meta")
    if isinstance(getattr(params_like, "layout", None), M.LM):
        return params_like.layout
    raise ValueError(f"params_like: an LM or a MeshTrainState, got "
                     f"{type(params_like).__name__}")


def reshard_plan(params_like, new_mesh, mode: str | None = None) -> dict:
    """{parameter name: the spec of its per-block tensor} of ``params_like``
    (an ``LM``, on any device, or a ``launch.steps.MeshTrainState``) on
    ``new_mesh`` (a joined mesh or a plan) in ``mode`` (default: the
    state's own, else "tp"): ``sharding.rules.model_specs``, the table of
    the train step."""
    from repro_torch.sharding import rules
    mode = mode or getattr(params_like, "mode", "tp")
    return rules.model_specs(_layout_model(params_like), new_mesh, mode)


def _read_blocks(ckpt_dir, step, layout, specs, mesh, prefix: str,
                 manifest, dtype=None) -> dict:
    """{parameter name: this rank's block on ``mesh.device``} of the
    checkpoint's leaves under ``prefix``, read whole one JAX leaf at a
    time; ``dtype``: the stored dtype (default: each parameter's)."""
    from repro_torch.checkpoint import store
    from repro_torch.models import convert
    from repro_torch.sharding import rules
    out = {}
    for path, (_, p_dtype, names) in convert.layout(layout).items():
        like = torch.empty((), dtype=dtype or p_dtype)
        whole = store.restore_leaf(ckpt_dir, step, prefix + "/".join(path),
                                   like, manifest=manifest)
        for name, layer in names:
            t = whole if layer is None else whole[layer]
            block = t[rules.block_slices(t.shape, specs[name], mesh)]
            out[name] = block.clone(
                memory_format=torch.contiguous_format).to(mesh.device)
    return out


def read_state_blocks(ckpt_dir: str, step: int, layout, specs: dict, mesh):
    """(params, m, v, the step counter) of a training-state checkpoint
    ({"params", "opt": {"m", "v", "step"}}), each a {parameter name: this
    rank's block under ``specs``} on ``mesh.device``."""
    from repro_torch.checkpoint import store
    manifest = store.load_manifest(ckpt_dir, step)
    dt = getattr(torch, layout.cfg.opt_state_dtype)
    params, m, v = (_read_blocks(ckpt_dir, step, layout, specs, mesh,
                                 prefix, manifest, dtype)
                    for prefix, dtype in (("params/", None), ("opt/m/", dt),
                                          ("opt/v/", dt)))
    counter = store.restore_leaf(
        ckpt_dir, step, "opt/step", torch.zeros((), dtype=torch.int32),
        manifest=manifest).to(mesh.device)
    return params, m, v, counter


def restore_on_mesh(ckpt_dir: str, step: int, params_like, new_mesh,
                    mode: str | None = None):
    """Checkpoint ``step`` -> this rank's blocks on ``new_mesh`` (joined),
    laid out by :func:`reshard_plan`.

    ``params_like`` an ``LM`` (on any device): a parameter checkpoint
    (the JAX tree of the parameters) -> {parameter name: block}. A
    ``launch.steps.MeshTrainState``: a training-state checkpoint (the
    tree of ``TrainState`` or ``MeshTrainState``, from any mesh or one
    device) -> a ``MeshTrainState`` on ``new_mesh`` in ``mode`` holding
    the blocks of the parameters and the moments and the step counter. A
    block is bitwise its slice of the saved leaf."""
    from repro_torch.checkpoint import store
    from repro_torch.launch.steps import MeshTrainState
    from repro_torch.models import model as M
    layout = _layout_model(params_like)
    mode = mode or getattr(params_like, "mode", "tp")
    specs = reshard_plan(layout, new_mesh, mode)
    if isinstance(params_like, M.LM):
        return _read_blocks(ckpt_dir, step, layout, specs, new_mesh, "",
                            store.load_manifest(ckpt_dir, step))
    params, m, v, counter = read_state_blocks(ckpt_dir, step, layout,
                                              specs, new_mesh)
    return MeshTrainState.from_blocks(layout.cfg, new_mesh, mode, params,
                                      {"m": m, "v": v, "step": counter})


def _layout_row(mesh, new_mesh, tables, names) -> torch.Tensor:
    """This rank's part of the layout exchange: its coordinates and sizes
    in both meshes (-1 where it has none) and each table's dtype and local
    shape."""
    row = []
    for m in (mesh, new_mesh):
        if m is None:
            row += [0, -1, -1, -1, -1]
        else:
            row += [1] + [m.index(a) for a in AXES] + [m.size(a)
                                                      for a in AXES]
    for name in names:
        t = None if tables is None else tables[name]
        if t is None:
            row += [-1] * (2 + _MAX_DIMS)
            continue
        if t.dim() > _MAX_DIMS or t.dtype not in _DTYPES:
            raise ValueError(f"table {name!r}: {t.dtype} with {t.dim()} "
                             f"dims; reshard_live moves up to {_MAX_DIMS} "
                             f"dims of {_DTYPES}")
        shape = list(t.shape) + [-1] * (_MAX_DIMS - t.dim())
        row += [_DTYPES.index(t.dtype), t.dim()] + shape
    return torch.tensor(row, dtype=torch.int64)


def _block(axes, shape, coords, sizes) -> tuple[tuple[int, int], ...]:
    """[start, stop) along each dim of the block that the mesh coordinate
    ``coords`` holds of a table of ``shape`` split by ``axes``."""
    out = []
    for dim, axis in enumerate(axes):
        if axis is None:
            out.append((0, shape[dim]))
            continue
        parts = sizes[AXES.index(axis)]
        if shape[dim] % parts:
            raise ValueError(f"dim {dim} ({shape[dim]}) does not split over "
                             f"the {parts} ranks of {axis!r}")
        step = shape[dim] // parts
        i = coords[AXES.index(axis)]
        out.append((i * step, (i + 1) * step))
    return tuple(out)


def _intersect(a, b):
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return out if all(x0 < x1 for x0, x1 in out) else None


def _region(t: torch.Tensor, region, origin) -> torch.Tensor:
    """The part ``region`` (whole-table coordinates) of ``t``, a block
    whose first element sits at ``origin``."""
    for dim, ((a, b), o) in enumerate(zip(region, origin)):
        t = t.narrow(dim, a - o, b - a)
    return t


def reshard_live(tables, new_mesh, plan: dict, *, mesh=None, group=None):
    """Move this rank's ``tables`` ({name: its block under ``mesh``, split
    as ``plan[name]`` says}, or None on a rank that holds none) onto
    ``new_mesh`` (this rank's part of the new mesh, or None on a rank
    outside it). A collective over ``group`` (a gloo group of every rank
    of the default group, ``launch.mesh.world_group``; None in a world of
    one rank): every rank calls it with the same ``plan``.

    Returns {name: this rank's block under ``new_mesh``} on the device of
    ``new_mesh``, or None on a rank outside it."""
    names = list(plan)
    if (tables is None) != (mesh is None):
        raise ValueError("a rank passes its tables with the mesh they are "
                         "laid out on, or neither")
    if tables is not None and set(tables) != set(names):
        raise ValueError(f"tables {sorted(tables)} are not the plan's "
                         f"{sorted(names)}")
    row = _layout_row(mesh, new_mesh, tables, names)
    if group is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("reshard_live in a world of "
                             f"{dist.get_world_size()} ranks needs the "
                             "world's gloo group")
        rows = [row]
    else:
        rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, row, group=group)
        annotate.TRAFFIC[LABEL] += (len(rows) - 1) * row.nbytes
    me = dist.get_rank() if group is not None else 0
    layout = torch.stack(rows).tolist()
    holders = [r for r, x in enumerate(layout) if x[0] == 1]
    targets = [r for r, x in enumerate(layout) if x[5] == 1]
    if not holders:
        raise ValueError("reshard_live: no rank holds the tables")

    # Every rank computes the same schedule from the exchanged layout.
    sends, recvs, pieces, out_meta = [], [], [], {}
    for t_i, name in enumerate(names):
        col = 10 + t_i * (2 + _MAX_DIMS)
        first = layout[holders[0]]
        dtype, ndim = _DTYPES[first[col]], first[col + 1]
        axes = plan[name]
        if len(axes) != ndim:
            raise ValueError(f"plan {name!r} {axes} has {len(axes)} dims, "
                             f"the table {ndim}")
        local = first[col + 2:col + 2 + ndim]
        old_sizes = first[3:5]
        shape = [n * (old_sizes[AXES.index(a)] if a else 1)
                 for n, a in zip(local, axes)]
        blocks = {}                    # old block -> the ranks holding it
        for r in holders:
            x = layout[r]
            if x[col:col + 2 + ndim] != first[col:col + 2 + ndim] \
                    or x[3:5] != old_sizes:
                raise ValueError(f"rank {r}'s {name!r} block does not "
                                 f"match rank {holders[0]}'s")
            b = _block(axes, shape, x[1:3], x[3:5])
            blocks.setdefault(b, []).append(r)
        for t in targets:
            x = layout[t]
            want = _block(axes, shape, x[6:8], x[8:10])
            if t == me:
                out_meta[name] = (want, dtype)
            for b, owners in blocks.items():
                region = _intersect(b, want)
                if region is None:
                    continue
                src = t if t in owners else owners[0]
                tag = len(pieces)
                pieces.append((name, t, src, region, b, tag))
                if src == me and t != me:
                    sends.append((name, t, region, b, tag))
                elif t == me and src != me:
                    recvs.append((name, src, region, tag, dtype))

    def staged(x):
        return x.cpu() if x.device.type == "cuda" else x

    works, kept, got = [], [], {}
    for name, t, region, b, tag in sends:
        part = staged(_region(tables[name], region,
                              [lo for lo, _ in b]).contiguous())
        kept.append(part)
        works.append(dist.isend(part, dst=t, group=group, tag=tag))
    for name, src, region, tag, dtype in recvs:
        buf = torch.empty([b - a for a, b in region], dtype=dtype)
        got[tag] = buf
        works.append(dist.irecv(buf, src=src, group=group, tag=tag))
    for w in works:
        w.wait()
    if new_mesh is None:
        return None
    out = {}
    for name in names:
        want, dtype = out_meta[name]
        origin = [lo for lo, _ in want]
        block = torch.empty([b - a for a, b in want], dtype=dtype,
                            device=new_mesh.device)
        for p_name, t, src, region, b, tag in pieces:
            if p_name != name or t != me:
                continue
            if src == me:
                part = _region(tables[name], region, [lo for lo, _ in b])
            else:
                part = got[tag]
                annotate.TRAFFIC[LABEL] += part.nbytes
            _region(block, region, origin).copy_(part)
        out[name] = block
    return out
