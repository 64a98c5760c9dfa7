"""The LM prefill and decode steps on a (data, model) mesh
(``launch.steps.make_mesh_prefill_step`` / ``make_mesh_decode_step``,
``MeshServeState``, ``sharding.rules.serve_plan``) against the JAX
package's single-device ``prefill`` and ``decode_step`` on the CPU.

The JAX package's own mesh steps cannot run here (ROADMAP Queue 3), so its
single-device ``prefill`` and ``decode_step`` under ``jax.jit`` are the
oracle. Every case draws the port's weights at ``smoke_config`` from seed
0 and hands the same numpy tree to both packages (``models.convert``):
each rank of a gloo world (``launch.local.run_local``; the rank bodies are
``tests/torch_decode_ranks.py``) cuts its blocks, prefills the prompt,
hands its caches to a decode cache and decodes the later positions one at
a time. Bars: every logits block within atol = rtol = 1e-4 of JAX's logits
cut by ``logits_spec``; every cache block within it of JAX's cache cut by
JAX's own ``cache_specs``, prefill's compact caches and the decode cache
after the last step; the bytes each rank receives by label exactly what
the layout implies (a TP leaf gathered over ``model`` fails them).

Worlds: 2x2 and 1x4, each started once for the module, all ten
architectures at 4 rows of 16 prompt tokens and 4 decode steps. On 1x4 the
GQA configs' 2 KV heads do not divide ``model``: their caches split the
sequence (SP over ``model``). On 2x2 a one-KV-head gemma3 at batch 1
splits it over the whole mesh, and its sliding window (8) crosses the
decode cache's block boundary at slot 167.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_decode_ranks as ranks
from repro.configs import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import steps as St
from repro_torch.launch.local import run_local
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, InputShape
from repro_torch.sharding import annotate, rules

ATOL = RTOL = 1e-4
ROWS, PROMPT, STEPS = 4, 16, 4
TIMEOUT = 240.0
F32 = 4


class FakeMesh:
    """Shape-only stand-in (the rules read .shape and .axis_names)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)

    def size(self, axis):
        return self.shape[axis]


WORLDS = {"2x2": (2, 2), "1x4": (1, 4)}
FULL_MESHES = {"16x16": {"data": 16, "model": 16},
               "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
               "2x2": {"data": 2, "model": 2},
               "1x4": {"data": 1, "model": 4},
               "4x1": {"data": 4, "model": 1}}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    rows: int = ROWS
    prompt: int = PROMPT
    steps: int = STEPS
    kv_heads: int = 0               # 0: smoke_config's
    expert_parallel: bool = False   # the port's cfg.moe_shard_map

    @property
    def over(self):
        return {"n_kv_heads": self.kv_heads} if self.kv_heads else {}


#: SP over the whole 2x2 mesh: one KV head divides no axis and one row
#: does not split over ``data``; 156 + 16 positions of a 668-slot cache
#: cut in four blocks of 167 put gemma3's window across the boundary.
WHOLE_MESH = Case("gemma3-27b", rows=1, prompt=156, steps=16, kv_heads=1)
#: mixtral's 4 experts one a rank of 1x4 under moe_shard_map: the train
#: step's expert-parallel path (``layers.moe_apply_shard_map``); JAX's
#: single-device plain path is the same function.
EXPERT_PARALLEL = Case("mixtral-8x22b", expert_parallel=True)
CASES = {"2x2": [Case(n) for n in ARCH_IDS] + [WHOLE_MESH],
         "1x4": [Case(n) for n in ARCH_IDS] + [EXPERT_PARALLEL]}


@functools.lru_cache(maxsize=None)
def setup(case: Case):
    """(port cfg, JAX cfg, the numpy weights, the numpy inputs)."""
    cfg = dataclasses.replace(smoke_config(case.name), **case.over,
                              moe_shard_map=case.expert_parallel)
    jcfg = dataclasses.replace(jax_smoke_config(case.name), **case.over)
    tree = convert.params_to_numpy(M.init(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(1)
    n = case.prompt + case.steps
    if cfg.frontend != "none":
        inputs = {"embeddings": rng.normal(
            size=(case.rows, n, cfg.d_model)).astype(np.float32)}
    else:
        inputs = {"tokens": rng.integers(0, cfg.vocab, (case.rows, n))
                  .astype(np.int32)}
    return cfg, jcfg, tree, inputs


@functools.lru_cache(maxsize=None)
def world(mesh_name: str):
    """Every case of ``mesh_name`` on one gloo world: results by rank."""
    cases = [dict(zip(("cfg", "tree", "inputs"),
                      (lambda s: (s[0], s[2], s[3]))(setup(c))),
                  prompt_len=c.prompt) for c in CASES[mesh_name]]
    return run_local(ranks.serve_cases, *WORLDS[mesh_name], args=(cases,),
                     timeout=TIMEOUT)


@functools.lru_cache(maxsize=None)
def _jit(fn, static):
    return jax.jit(fn, static_argnums=static)


@functools.lru_cache(maxsize=None)
def jax_run(case: Case):
    """JAX's single-device prefill, the handoff into a decode cache of
    prompt + CACHE_PAD slots and the decode steps: (logits [prefill,
    step...], prefill's caches, the decode cache after the last step),
    numpy."""
    _, jcfg, tree, inputs = setup(case)
    params = jax.tree.map(jnp.asarray, tree)
    (key, x), S = next(iter(inputs.items())), case.prompt
    logits, caches = _jit(JM.prefill, (2,))(
        params, {key: jnp.asarray(x[:, :S])}, jcfg)
    cache = JM.init_decode_cache(jcfg, case.rows, S + St.CACHE_PAD - 1,
                                 dtype=jnp.float32)
    ssm, kv = {"ssm": (caches, None), "hybrid": caches}.get(
        jcfg.family, (None, caches))
    if kv is not None:
        cache["attn"] = {n: cache["attn"][n].at[..., :S, :, :].set(kv[n])
                         for n in kv}
    if ssm is not None:
        cache["ssm"] = dict(ssm)
    out = [np.asarray(logits)]
    step = _jit(JM.decode_step, (3,))
    for t in range(S, S + case.steps):
        logits, cache = step(params, {key: jnp.asarray(x[:, t:t + 1]),
                                      "cache_index": jnp.int32(t)},
                             cache, jcfg)
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, caches), jax.tree.map(np.asarray,
                                                               cache)


def jax_specs(tree, jcfg, mesh):
    """JAX's own ``cache_specs`` of a cache tree, as tuples, in the order
    of ``jax.tree.leaves``."""
    specs = JR.cache_specs(tree, jcfg, mesh)
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, P))]


def check_blocks(got, want, specs, mesh, coords, what):
    """Every leaf of a rank's block tree against JAX's whole tree cut by
    ``specs``; the largest |d|."""
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    worst = 0.0
    for g, w, spec in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                          specs):
        block = w[rules.block_slices(w.shape, spec, mesh, coords)]
        assert g.shape == block.shape, (what, g.shape, block.shape, spec)
        np.testing.assert_allclose(g, block, atol=ATOL, rtol=RTOL,
                                   err_msg=what)
        worst = max(worst, float(np.abs(g - block).max()))
    return worst


def assemble(blocks, coords, mesh, spec, shape):
    """The whole logits from the ranks' blocks by ``spec``."""
    out = np.full(shape, np.nan, np.float32)
    for block, at in zip(blocks, coords):
        out[rules.block_slices(shape, spec, mesh, at)] = block
    return out


def check_case(mesh_name, case, results):
    """Logits, gathered and by block, and both caches of every rank."""
    cfg, jcfg, _, _ = setup(case)
    mesh = FakeMesh(dict(zip(("data", "model"), WORLDS[mesh_name])))
    want_logits, want_prefill, want_cache = jax_run(case)
    coords = [r["coords"] for r in results]
    l_spec = tuple(JR.logits_spec(mesh, case.rows, cfg.vocab))
    shape = (case.rows, 1, cfg.vocab)
    worst = 0.0
    for i, want in enumerate(want_logits):
        blocks = [r["prefill"] if i == 0 else r["decode"][i - 1]
                  for r in results]
        whole = assemble(blocks, coords, mesh, l_spec, shape)
        np.testing.assert_allclose(whole, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{case} logits {i}")
        worst = max(worst, float(np.abs(whole - want).max()))
        for block, at in zip(blocks, coords):
            sl = rules.block_slices(shape, l_spec, mesh, at)
            assert block.shape == want[sl].shape, (case, l_spec)
    p_specs = jax_specs(want_prefill, jcfg, mesh)
    d_specs = jax_specs(want_cache, jcfg, mesh)
    for r in results:
        worst = max(worst, check_blocks(r["prefill_cache"], want_prefill,
                                        p_specs, mesh, r["coords"],
                                        f"{case} prefill cache"),
                    check_blocks(r["cache"], want_cache, d_specs, mesh,
                                 r["coords"], f"{case} decode cache"))
    print(f"{mesh_name} {case}: max |d| {worst:.3g}; plan "
          f"{results[0]['plan_decode']}; rank 0 bytes a decode step "
          f"{results[0]['bytes']['decode'][0]}")


@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(WORLDS))
def test_mesh_prefill_decode_match_jax(mesh_name, name):
    i = [c.name for c in CASES[mesh_name]].index(name)
    results = [r[i] for r in world(mesh_name)]
    check_case(mesh_name, CASES[mesh_name][i], results)


def test_sp_over_the_whole_mesh_window_across_blocks():
    """One KV head, one row on 2x2: the decode cache's sequence splits over
    (data, model), each rank writing only the slots it owns; the window
    of the last steps spans blocks 0 and 1; the prompt's cache is split
    too and gathered along the sequence in the handoff."""
    results = [r[-1] for r in world("2x2")]
    check_case("2x2", WHOLE_MESH, results)
    cfg = setup(WHOLE_MESH)[0]
    r0 = results[0]
    assert set(r0["plan_decode"][f"blocks.{i}.attn"] for i in range(4)) == \
        {("seq", ("data", "model"))}
    block = (WHOLE_MESH.prompt + St.CACHE_PAD) // 4
    last = WHOLE_MESH.prompt + WHOLE_MESH.steps - 1
    assert last - cfg.sliding_window < block <= last      # across a boundary
    for r in results:
        n = r["cache"]["attn"]["k"].shape[2]
        assert n == block
        # a block of 39 prompt slots a rank, gathered from 3 other ranks
        kv = r["prefill_cache"]["k"]
        assert r["bytes"]["handoff"] == {"cache_handoff": 2 * 3 * kv.nbytes}
    per_layer = sum(s - 1 for s in (2, 2)) * F32 * (
        WHOLE_MESH.rows * cfg.n_heads * (cfg.head_dim + 2))
    for b in r0["bytes"]["decode"]:
        assert b["sp_combine"] == cfg.n_layers * per_layer


def test_expert_parallel_moe_serves_its_own_experts():
    """Under moe_shard_map each rank of 1x4 holds one packed expert row
    and computes it where it lies: ``moe_out`` sums the partial outputs
    once a layer a step, and the experts are gathered over no axis."""
    results = [r[-1] for r in world("1x4")]
    check_case("1x4", EXPERT_PARALLEL, results)
    cfg = setup(EXPERT_PARALLEL)[0]
    act = ROWS * cfg.d_model * F32
    for r in results:
        for b in r["bytes"]["decode"]:
            assert b["moe_out"] == cfg.n_layers * 3 * act


def access_counts(cfg, name):
    """How many times a decode step reads parameter ``name``."""
    if name.startswith("shared_attn."):
        return cfg.n_layers // cfg.hybrid_attn_every
    if name == "embed":
        return int(cfg.frontend == "none") + int(cfg.tie_embeddings)
    return 1


def expected_bytes(cfg, mesh, plan, rows, seq=1):
    """Bytes a rank receives by label in one step of ``seq`` tokens at
    ``rows`` global rows, from the rules' layout alone: a leaf the plan
    computes as its TP block gathered over ``data``, every other leaf over
    every axis its spec names; one ``tp_reduce`` of the (rows, seq, d)
    activations for each TP attention and MLP, one ``vocab_embed``, and
    the partial softmaxes of each SP attention."""
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, mesh, "tp")
    tp = rules.block_leaves(plan, specs)
    out = {}
    gather = 0
    m = mesh.size("model")
    ep = cfg.moe_shard_map and m > 1
    for name, p in layout.named_parameters():
        axes = rules.spec_axes(specs[name])
        block = p.numel() // math.prod(mesh.size(a) for a in axes)
        local = name in tp or (ep and ".moe.w_" in name)
        got = [a for a in axes if not (local and a == "model")]
        gather += (access_counts(cfg, name) * block * F32
                   * (math.prod(mesh.size(a) for a in got) - 1))
    out["fsdp_gather"] = gather
    b_loc = rows // mesh.size("data") if rows % mesh.size("data") == 0 \
        else rows
    act = b_loc * seq * cfg.d_model * F32
    reps = {n: access_counts(cfg, n + ".wq") for n in plan}
    tp_mods = sum(reps[n] for n, mode in plan.items()
                  if (n.endswith(".attn") and mode == "heads")
                  or (n.endswith(".mlp") and mode == "tp"))
    out["tp_reduce"] = tp_mods * (m - 1) * act
    if cfg.frontend == "none":
        out["vocab_embed"] = (m - 1) * act if plan["embed"] == "vocab" else 0
    sp = 0
    for n, mode in plan.items():
        if isinstance(mode, tuple):
            sp += sum(mesh.size(a) - 1 for a in mode[1]) * F32 * (
                b_loc * cfg.n_heads * (cfg.head_dim + 2))
    out["sp_combine"] = sp
    ssm = [n for n, mode in plan.items() if n.endswith(".ssm")
           and mode == "heads"]
    d_in = cfg.ssm_expand * cfg.d_model
    out["ssm_heads"] = len(ssm) * (m - 1) * b_loc * d_in // m * F32
    out["moe_out"] = cfg.n_layers * (m - 1) * act if ep else 0
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("mesh_name", list(WORLDS))
def test_decode_bytes_are_the_layouts(mesh_name):
    """Each architecture's bytes a decode step, on every rank, exactly what
    the rules' layout implies; olmo's also for the prefill. On 1x4 olmo
    gathers no byte: every leaf is a TP block or parameter-free, and data
    has one rank."""
    mesh = FakeMesh(dict(zip(("data", "model"), WORLDS[mesh_name])))
    for i, case in enumerate(CASES[mesh_name]):
        cfg = setup(case)[0]
        for r in world(mesh_name):
            run = r[i]
            want = expected_bytes(cfg, mesh, run["plan_decode"], case.rows)
            for got in run["bytes"]["decode"]:
                assert got == want, (mesh_name, case, got, want)
            if case.name == "olmo-1b":
                want = expected_bytes(cfg, mesh, run["plan_prefill"],
                                      case.rows, case.prompt)
                assert run["bytes"]["prefill"] == want
                assert run["bytes"]["handoff"] == {}
    if mesh_name == "1x4":
        olmo = world(mesh_name)[0][ARCH_IDS.index("olmo-1b")]
        assert "fsdp_gather" not in olmo["bytes"]["decode"][0]


def test_gathering_tp_leaves_over_model_would_fail_the_bytes():
    """The byte bar catches a regression to gather-on-use: olmo's decode
    step with every leaf gathered whole moves other bytes."""
    cfg = smoke_config("olmo-1b")
    mesh = FakeMesh({"data": 2, "model": 2})
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, mesh, "tp")
    cache = rules.cache_specs(St.abstract_cache(cfg, InputShape(
        "d", PROMPT, ROWS, "decode")), cfg, mesh)
    plan = rules.serve_plan(specs, cache)
    gathered = {k: ("whole" if k in ("embed", "head") else
                    "whole" if v in ("heads", "tp") else v)
                for k, v in plan.items()}
    assert expected_bytes(cfg, mesh, plan, ROWS)["fsdp_gather"] != \
        expected_bytes(cfg, mesh, gathered, ROWS)["fsdp_gather"]


# ----------------------------------------------------------------------------
# The plan on the ten full configs
# ----------------------------------------------------------------------------

def ssm_heads(cfg):
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


@pytest.mark.parametrize("mesh_name", list(FULL_MESHES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_serve_plan_on_the_full_configs(name, mesh_name):
    """``serve_plan`` of decode_32k (and long_500k where the arch runs it)
    against the configs' arithmetic: attention on the rank's heads where
    the KV heads divide ``model``, else SP where the cache's capacity
    divides the SP axes; a dense MLP TP where d_ff divides ``model``; the
    vocabulary where it divides; SSM heads where they divide. No leaf the
    plan computes as a block has a spec without ``model``."""
    cfg = get_config(name)
    mesh = FakeMesh(FULL_MESHES[mesh_name])
    m = mesh.shape["model"]
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, mesh, "tp")
    cells = ["decode_32k"] + (["long_500k"] if name in (
        "mamba2-2.7b", "zamba2-2.7b", "gemma3-27b") else [])
    for cell in cells:
        shape = SHAPES[cell]
        cache = rules.cache_specs(St.abstract_cache(cfg, shape), cfg, mesh)
        plan = rules.serve_plan(specs, cache)
        cap = shape.seq_len + St.CACHE_PAD
        dp = math.prod(v for a, v in mesh.shape.items() if a != "model")
        for mod, mode in plan.items():
            if mod.endswith(".attn"):
                if cfg.n_kv_heads % m == 0:
                    want = "heads"
                else:
                    axes = (("model",) if shape.global_batch % dp == 0
                            else tuple(mesh.axis_names))
                    want = ("seq", axes) if cap % math.prod(
                        mesh.shape[a] for a in axes) == 0 else "whole"
            elif mod.endswith(".mlp"):
                want = "tp" if cfg.d_ff % m == 0 else "whole"
            elif mod.endswith(".ssm"):
                want = "heads" if ssm_heads(cfg) % m == 0 else "whole"
            else:
                want = "vocab" if cfg.vocab % m == 0 else "whole"
            assert mode == want, (cell, mod, mode, want)
        for leaf in rules.block_leaves(plan, specs):
            assert "model" in rules.spec_axes(specs[leaf]), (cell, leaf)
        n_attn = sum(1 for n in plan if n.endswith(".attn"))
        assert n_attn == (0 if cfg.family == "ssm" else
                          1 if cfg.family == "hybrid" else cfg.n_layers)


def test_serve_plan_refuses_a_cache_the_weights_cannot_serve():
    """A cache whose KV heads split over ``model`` while ``wk`` keeps its
    heads whole is no layout of the rules."""
    cfg = smoke_config("olmo-1b")
    mesh = FakeMesh({"data": 2, "model": 2})
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, mesh, "tp")
    specs["blocks.0.attn.wk"] = ("data", None, "model")
    cache = rules.cache_specs(St.abstract_cache(cfg, SHAPES["decode_32k"]),
                              cfg, mesh)
    with pytest.raises(ValueError, match="KV heads"):
        rules.serve_plan(specs, cache)
    assert rules.without_model(("data", "model", None)) == \
        ("data", None, None)
    with pytest.raises(ValueError, match="not a TP block"):
        rules.without_model((("data", "model"), None))


# ----------------------------------------------------------------------------
# One rank, the cache helpers and the refusals
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_IDS)
def test_one_rank_mesh_is_bitwise_the_single_device(name):
    """A 1 x 1 mesh with no process group: the plan's TP modules compute
    on whole blocks and every collective moves nothing, so the prefill,
    its handoff and the decode steps are the single-device ones bit for
    bit."""
    case = Case(name, rows=2, steps=3)
    cfg, _, tree, inputs = setup(case)
    (key, x), S = next(iter(inputs.items())), case.prompt
    x = torch.as_tensor(x)
    mesh = make_test_mesh(1, 1, device="cpu")
    model = convert.params_from_numpy(tree, cfg, "cpu")
    state = St.MeshServeState.from_model(model, mesh)
    prompt = InputShape("p", S, case.rows, "prefill")
    decode = InputShape("d", S, case.rows, "decode")
    prefill, (params_abs, batch_abs) = St.make_mesh_prefill_step(
        cfg, prompt, mesh)
    step, (_, step_abs, cache_abs) = St.make_mesh_decode_step(cfg, decode,
                                                              mesh)
    assert all(t.device.type == "meta" for t in params_abs.parameters())
    assert batch_abs[key].shape[:2] == (case.rows, S)
    assert step_abs[key].shape[:2] == (case.rows, 1)
    annotate.reset_traffic()
    logits, caches = prefill(state, {key: x[:, :S]})
    want, want_caches = M.prefill(model, {key: x[:, :S]})
    assert torch.equal(logits, want)
    assert jax.tree.all(jax.tree.map(torch.equal, caches, want_caches))
    cache = St.init_mesh_decode_cache(cfg, decode, mesh, torch.float32)
    ref = St.init_mesh_decode_cache(cfg, decode, mesh, torch.float32)
    assert jax.tree.all(jax.tree.map(lambda a, b: a.shape == b.shape,
                                     cache, cache_abs))
    St.handoff_prefill(caches, cache, cfg, mesh, prompt, decode)
    St.handoff_prefill(want_caches, ref, cfg, mesh, prompt, decode)
    for t in range(S, S + case.steps):
        batch = {key: x[:, t:t + 1], "cache_index": t}
        got, cache = step(state, batch, cache)
        want, ref = M.decode_step(model, batch, ref)
        assert torch.equal(got, want), (name, t)
    assert jax.tree.all(jax.tree.map(torch.equal, cache, ref))
    assert annotate.traffic() == {}


def test_cache_blocks_cut_by_the_rules():
    """``cache_blocks`` of a whole decode cache is each rank's
    ``block_slices`` of it; ``init_mesh_decode_cache`` allocates those
    blocks' shapes and dtypes."""
    cfg = smoke_config("zamba2-2.7b")
    shape = InputShape("d", 16, 4, "decode")
    whole = M.init_decode_cache(cfg, 4, 16 + St.CACHE_PAD - 1,
                                torch.float32, device="cpu")
    for leaf in jax.tree.leaves(whole):
        leaf.copy_(torch.randn(leaf.shape))
    mesh = make_test_mesh(1, 1, device="cpu")
    blocks = St.cache_blocks(whole, cfg, mesh)
    assert jax.tree.all(jax.tree.map(torch.equal, blocks, whole))
    empty = St.init_mesh_decode_cache(cfg, shape, mesh, torch.float32)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype, empty,
        whole))


def test_mesh_steps_refuse_what_they_cannot_do():
    cfg = smoke_config("olmo-1b")
    mesh = make_test_mesh(1, 1, device="cpu")
    state = St.MeshServeState.init(cfg, mesh)
    prefill, _ = St.make_mesh_prefill_step(
        cfg, InputShape("p", 8, 2, "prefill"), mesh)
    with pytest.raises(ValueError, match="takes 2 rows of 8"):
        prefill(state, {"tokens": torch.zeros((2, 9), dtype=torch.long)})
    with pytest.raises(ValueError, match="MeshServeState"):
        prefill(object(), {"tokens": torch.zeros((2, 8), dtype=torch.long)})
    step, _ = St.make_mesh_decode_step(
        cfg, InputShape("d", 8, 2, "decode"), mesh)
    wrong = St.init_mesh_decode_cache(
        cfg, InputShape("d", 16, 2, "decode"), mesh, torch.float32)
    with pytest.raises(ValueError, match="cache blocks"):
        step(state, {"tokens": torch.zeros((2, 1), dtype=torch.long),
                     "cache_index": 0}, wrong)
    cache = St.init_mesh_decode_cache(
        cfg, InputShape("d", 8, 2, "decode"), mesh, torch.float32)
    with pytest.raises(IndexError):
        step(state, {"tokens": torch.zeros((2, 1), dtype=torch.long),
                     "cache_index": 8 + St.CACHE_PAD}, cache)
    # NCCL asks for a card: none here, and the CPU is refused.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh(1, 1, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_test_mesh(1, 1, backend="nccl", device="cpu")
