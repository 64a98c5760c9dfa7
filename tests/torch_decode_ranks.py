"""Rank bodies of the LM mesh prefill and decode tests
(``test_torch_mesh_decode.py``).

``repro_torch.launch.local.run_local`` runs each function on every rank of
a local gloo mesh on the CPU. They import only the port (never JAX): each
rank carries the numpy weights it is given across (``models.convert``),
cuts its blocks (``MeshServeState.from_model``), runs the mesh prefill
step, hands its caches to a decode cache and runs the decode steps, and
returns numpy results that the test process holds to the JAX package's
single-device prefill and decode.
"""
import torch

from repro_torch.launch import steps as St
from repro_torch.models import convert
from repro_torch.models.config import InputShape
from repro_torch.sharding import annotate


def _np(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np(v) for v in tree)
    return tree.detach().cpu().float().numpy().copy()


def serve(mesh, cfg, tree, inputs, prompt_len):
    """The mesh prefill of the first ``prompt_len`` positions of
    ``inputs`` ({"tokens" or "embeddings": (B, prompt_len + steps, ...)}
    numpy), then one decode step for each later position, from ``tree``
    (the JAX-layout numpy weights). Returns this rank's coordinates, the
    plans of both steps, its logits blocks, its caches' blocks (prefill's
    and the decode cache after the last step) and the bytes it received
    by label in the prefill, the handoff and each decode step."""
    key, x = next(iter(inputs.items()))
    x = torch.as_tensor(x)
    rows, steps = x.shape[0], x.shape[1] - prompt_len
    model = convert.params_from_numpy(tree, cfg, "cpu")
    state = St.MeshServeState.from_model(model, mesh)
    del model
    prompt = InputShape("prefill", prompt_len, rows, "prefill")
    decode = InputShape("decode", prompt_len, rows, "decode")
    prefill_step, _ = St.make_mesh_prefill_step(cfg, prompt, mesh)
    decode_step, _ = St.make_mesh_decode_step(cfg, decode, mesh)
    out = {"coords": {a: mesh.index(a) for a in ("data", "model")},
           "bytes": {}}
    annotate.reset_traffic()
    logits, caches = prefill_step(state, {key: x[:, :prompt_len]})
    out["bytes"]["prefill"] = annotate.traffic()
    out["plan_prefill"] = state.plan
    out["prefill"], out["prefill_cache"] = _np(logits), _np(caches)
    cache = St.init_mesh_decode_cache(cfg, decode, mesh, torch.float32)
    annotate.reset_traffic()
    St.handoff_prefill(caches, cache, cfg, mesh, prompt, decode)
    out["bytes"]["handoff"] = annotate.traffic()
    out["decode"], out["bytes"]["decode"] = [], []
    for t in range(prompt_len, prompt_len + steps):
        annotate.reset_traffic()
        logits, cache = decode_step(
            state, {key: x[:, t:t + 1], "cache_index": t}, cache)
        out["bytes"]["decode"].append(annotate.traffic())
        out["decode"].append(_np(logits))
    out["plan_decode"] = state.plan
    out["cache"] = _np(cache)
    return out


def serve_cases(mesh, cases):
    """``serve`` for each case (a dict of its keyword arguments)."""
    return [serve(mesh, **case) for case in cases]


def one_rank_against_one_device(mesh, cfg, inputs, prompt_len):
    """On a one-rank mesh: the mesh prefill, handoff and decode steps and
    the single-device ``prefill`` / ``decode_step`` from the same seed-0
    weights on ``mesh.device``; whether each result is bitwise equal and
    whether any byte crossed."""
    from repro_torch.launch.mesh import AXES
    from repro_torch.models import model as M
    assert all(mesh.size(a) == 1 for a in AXES)
    (key, x), S = next(iter(inputs.items())), prompt_len
    x = torch.as_tensor(x, device=mesh.device)
    model = M.init(cfg, seed=0, device=mesh.device)
    state = St.MeshServeState.from_model(model, mesh)
    prompt = InputShape("prefill", S, x.shape[0], "prefill")
    decode = InputShape("decode", S, x.shape[0], "decode")
    prefill_step, _ = St.make_mesh_prefill_step(cfg, prompt, mesh)
    decode_step, _ = St.make_mesh_decode_step(cfg, decode, mesh)
    annotate.reset_traffic()
    got, got_caches = prefill_step(state, {key: x[:, :S]})
    want, want_caches = M.prefill(model, {key: x[:, :S]})
    out = {"prefill": torch.equal(got, want),
           "caches": all(torch.equal(a, b) for a, b in zip(
               _leaves(got_caches), _leaves(want_caches)))}
    cache = St.init_mesh_decode_cache(cfg, decode, mesh, torch.float32)
    ref = St.init_mesh_decode_cache(cfg, decode, mesh, torch.float32)
    St.handoff_prefill(got_caches, cache, cfg, mesh, prompt, decode)
    St.handoff_prefill(want_caches, ref, cfg, mesh, prompt, decode)
    steps = []
    for t in range(S, x.shape[1]):
        batch = {key: x[:, t:t + 1], "cache_index": t}
        got, cache = decode_step(state, batch, cache)
        want, ref = M.decode_step(model, batch, ref)
        steps.append(torch.equal(got, want))
    out["steps"] = steps
    out["cache"] = all(torch.equal(a, b) for a, b in zip(_leaves(cache),
                                                         _leaves(ref)))
    out["bytes"] = annotate.traffic()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
