"""The kernels on the mesh: each rank launches the port's kernels on its
shard, and the collectives of ``sharding.annotate`` join the shards.

Counterpart of the JAX package's ``kernels/partition.py``, where each shim
wraps a kernel in a ``shard_map`` with its (in_specs, out_specs). Here a
rank already holds its shards (``launch.search.SEARCH_PLAN``): queries split
over ``data``, corpus rows over ``model``, the vocabulary coordinates
replicated. So each shim is the single-device wrapper on the rank's
operands, plus the collective the partitioning implies:

* ``dist_topk_sharded`` (Phase 1, K1) - the rank's queries against its
  contiguous vocabulary slice coords[v0:v1]; the (nq/dp, v/mp, k) ladders
  are then gathered over ``model`` (``annotate.emd_ladder``).
* Phase 2/3 (JAX's ``act_pour_sharded``) needs no shim here: the engine's
  own call of the fused K2 (``lc.pour_blocked``) on the rank's row shard
  against the gathered ladders is the (nq/dp, n/mp) block, and so are K3's
  and K4's all-rows forms on those rows.
* ``cand_sharded`` - candidates are global row ids and a rank holds only
  its rows. Each ``model`` rank scores the candidates it owns against its
  shard, at their shard-local ids, through the engines' own candidate
  kernels (K3 on the corpus rows, the valid-bin K4), zeroes the slots it
  does not own, and one sum all-reduce over ``model`` joins the (nq/dp,
  b) scores (exact: each slot has one owner). That moves 4 bytes a
  candidate, whatever n and hmax. (JAX gathers the candidate rows
  themselves outside its ``shard_map``, nq*b*hmax ids and weights; the
  scores are the same bits for 1/(2*hmax) of the bytes.) Every model rank
  already scored all b slots of its queries, so no kernel does more work.

The preconditions (``vocab_shardable``, ``rows_shardable``; ``EmdIndex``
pads the queries to the ``data`` size) say when a dim splits. Where the
vocabulary does not split over ``model``, every model rank runs the whole
Phase 1 for its queries, as JAX does where its precondition fails
(``core/lc.py:534-547`` there).
"""
from __future__ import annotations

import torch

from repro_torch.core import lc
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import model_axis_size
from repro_torch.sharding import annotate


def vocab_shardable(mesh, v: int) -> bool:
    """True when the vocabulary rows split evenly over ``model``: the
    precondition of :func:`dist_topk_sharded` on a rank's queries."""
    return v % model_axis_size(mesh) == 0


def rows_shardable(mesh, n: int) -> bool:
    """True when n corpus rows split evenly over ``model``."""
    return n % model_axis_size(mesh) == 0


def axis_slice(mesh, axis: str, size: int) -> tuple[int, int]:
    """[start, stop) of this rank's even part of ``size`` along ``axis``
    (``size`` must divide)."""
    parts = mesh.size(axis)
    if size % parts:
        raise ValueError(f"{size} does not split over the {parts} ranks of "
                         f"the {axis!r} axis")
    step = size // parts
    i = mesh.index(axis)
    return i * step, (i + 1) * step


def dist_topk_sharded(mesh, coords: torch.Tensor, Q_ids: torch.Tensor,
                      Q_w: torch.Tensor, k: int, *,
                      out_dtype: torch.dtype = torch.float32,
                      block_v: int | None = None,
                      block_h: int | None = None):
    """K1 on the mesh: this rank's queries (nq/dp, h) against its
    vocabulary slice of ``coords`` (v, m), float32 or the ``bf16_agg``
    policy's bfloat16 -> Z, W (nq/dp, v, k) in ``out_dtype``, gathered
    over ``model``. The plain version pins each bin's distance to its own
    row at the slice's offset (``row0``). Needs ``vocab_shardable``."""
    v0, v1 = axis_slice(mesh, "model", coords.shape[0])
    Z, S = kops.dist_topk_batched(coords[v0:v1], coords[Q_ids], Q_w > 0.0,
                                  k, out_dtype=out_dtype, qids=Q_ids,
                                  row0=v0, block_v=block_v, block_h=block_h)
    W = lc.gather_capacities(Q_w, S).to(out_dtype)
    return annotate.emd_ladder(Z, mesh), annotate.emd_ladder(W, mesh)


def cand_sharded(mesh, fn, corpus: lc.Corpus, Q_ids: torch.Tensor,
                 Q_w: torch.Tensor, cand: torch.Tensor, **kw
                 ) -> torch.Tensor:
    """A candidate scorer ``fn(corpus, Q_ids, Q_w, cand, **kw)`` on the
    mesh: this rank's queries against their global candidate rows ``cand``
    (nq/dp, b) -> the (nq/dp, b) scores, the same on every model rank.
    ``corpus`` is this rank's row shard. Each model rank scores the
    candidates it owns on its shard (the others at its row 0, then zeroed)
    and one sum over ``model`` joins the scores: each slot has one owner
    and every other rank adds +0.0, so the sum is that owner's score,
    bit for bit. On one model rank nothing crosses."""
    if model_axis_size(mesh) == 1:
        return fn(corpus, Q_ids, Q_w, cand, mesh=mesh, **kw)
    rel = cand.long() - mesh.index("model") * corpus.n
    own = (rel >= 0) & (rel < corpus.n)
    s = fn(corpus, Q_ids, Q_w, torch.where(own, rel, 0), mesh=mesh, **kw)
    s = torch.where(own, s, 0.0)
    return annotate.all_reduce_sum(s, mesh, "model", "cand_scores")
