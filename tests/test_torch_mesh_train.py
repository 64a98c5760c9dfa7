"""The LM train step on a (data, model) mesh (``launch.steps.
make_mesh_train_step``, ``MeshTrainState``; ``runtime.elastic``'s
``reshard_plan`` and ``restore_on_mesh``) against the JAX package's
single-device step on the CPU.

The JAX package's own mesh tests cannot run here (ROADMAP Queue 3), so its
single-device ``make_train_step`` under ``jax.jit`` is the oracle: every
rank of a gloo world (``launch.local.run_local``; the rank bodies are
``tests/torch_train_ranks.py``) draws the weights of ``smoke_config`` at
LAYERS (2) layers from seed 0 and takes two mesh steps of the same global
batches; JAX takes two steps from
the same weights (``convert.params_to_numpy``). Bars, test_torch_train's:
the loss and grad norm within rtol 1e-4; every parameter within
STEP_LR_FRACTION (0.25) of the step's learning rate (AdamW moves a
parameter whose gradient is near eps by a visible part of lr); the first
moment within atol = rtol = 1e-4. The readings: the losses within 1e-6,
the parameters at most 0.071 of their bar, the moments 1.8e-4 of theirs
(``pytest -s`` prints them).

Cases: olmo at 2x2 tp, 2x2 fsdp, 1x4 tp and a loss_mask that differs
across the data ranks with n_micro=2; mixtral with moe_shard_map at 1x4,
modes tp and ep, remat dots and full (the experts computed where they
lie, the ``moe_out`` all-reduce not repeated by the dots recomputation);
zamba2 at 2x2; the seven other architectures at 2x2 tp against the
port's single-device step, which test_torch_train holds to JAX. Every
rank holds only the blocks the rules give it. A checkpoint written from
2x2 restores bitwise on 1x4 and 4x1 and trains on.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as JSt
from repro.models.config import InputShape as JInputShape
from repro.optim import adamw as JA
from repro_torch.checkpoint import store
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.launch import steps as St
from repro_torch.launch.local import run_local
from repro_torch.launch.mesh import make_test_mesh, plan_mesh
from repro_torch.models import convert, parity
from repro_torch.models import model as M
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.sharding import rules

RTOL = 1e-4
STEP_LR_FRACTION = 0.25
ROWS, SEQ, STEPS = 4, 16, 2
#: Layers of the gloo worlds' models: every leaf kind at half the
#: collectives of smoke_config's 4 (a gloo collective's latency is most of
#: a step here).
LAYERS = 2
TIMEOUT = 240.0


def small(name, **over):
    """``smoke_config(name)`` at LAYERS layers, with ``over``."""
    return dataclasses.replace(smoke_config(name), n_layers=LAYERS, **over)


def batches_of(cfg, n=STEPS, mask=False):
    out = [parity.train_batch(cfg, s, batch=ROWS, seq=SEQ) for s in range(n)]
    if mask:
        rng = np.random.default_rng(5)
        for b in out:
            m = (rng.random((ROWS, SEQ)) < 0.3).astype(np.float32)
            m[0] = 1.0                  # data rank 0's row of chunk 0
            m[3] = 0.0
            b["loss_mask"] = m
    return out


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def worst(got, want, atol, rtol):
    """Every leaf of two numpy trees within atol + rtol |want|; the largest
    |d| / that bar."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    out = 0.0
    for path in w:
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=rtol,
                                   err_msg="/".join(map(str, path)))
        out = max(out, float((np.abs(g[path] - w[path])
                              / (atol + rtol * np.abs(w[path]))).max()))
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg, n_micro):
    return jax.jit(JSt.make_train_step(
        jcfg, JInputShape("t", SEQ, ROWS, "train"),
        JA.AdamWConfig(**ranks.OPT), n_micro=n_micro))


def jax_run(name, batches, n_micro=1, **over):
    """JAX's single-device steps from the port's seed-0 weights: [(loss,
    grad norm, lr)], the parameters and the first moment (numpy trees)."""
    cfg = small(name, **over)
    jcfg = dataclasses.replace(jax_smoke_config(name), n_layers=LAYERS,
                               **over)
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        M.init(cfg, seed=0, device="cpu")))
    opt = JA.init(params, jcfg.opt_state_dtype)
    metrics = []
    for b in batches:
        params, opt, m = _jax_step(jcfg, n_micro)(
            params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(tuple(float(m[k]) for k in ("loss", "grad_norm",
                                                    "lr")))
    return (metrics, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, opt["m"]))


def port_run(cfg, batches):
    """The port's single-device steps, as ``jax_run`` returns them."""
    model = M.init(cfg, seed=0, device="cpu")
    opt = adamw.init(dict(model.named_parameters()))
    step = St.make_train_step(InputShape("t", SEQ, ROWS, "train"),
                              adamw.AdamWConfig(**ranks.OPT), n_micro=1)
    metrics = []
    for b in batches:
        model, opt, m = step(model, opt, {k: torch.as_tensor(v)
                                          for k, v in b.items()})
        metrics.append(tuple(float(m[k]) for k in ("loss", "grad_norm",
                                                    "lr")))
    return (metrics, convert.params_to_numpy(model),
            convert.opt_state_to_numpy(model, opt)["m"])


def check_run(label, results, want, mesh_shape):
    """Every rank's metrics equal; the leader's whole state against
    ``want`` (``jax_run``'s); every rank holding its blocks alone."""
    metrics, params, m = want
    got = results[0]
    assert all(r["metrics"] == got["metrics"] for r in results), label
    for (loss, norm, lr), (jl, jn, jlr) in zip(got["metrics"], metrics):
        np.testing.assert_allclose(loss, jl, rtol=RTOL, err_msg=label)
        np.testing.assert_allclose(norm, jn, rtol=RTOL, err_msg=label)
        assert lr == jlr
    p_bar = STEP_LR_FRACTION * metrics[-1][2]
    wp = worst(got["tree"]["params"], params, p_bar, 0.0)
    wm = worst(got["tree"]["opt"]["m"], m, RTOL, RTOL)
    assert int(got["tree"]["opt"]["step"]) == STEPS
    assert all(r["tree"] is None for r in results[1:])
    for r in results:
        assert r["blocks"] == r["moments"]
    n_block = sum(np.prod(s) for s in got["blocks"].values())
    n_whole = sum(v.size for v in flat(params).values())
    assert n_block < n_whole or mesh_shape == (1, 1)
    d_loss = abs(got["metrics"][-1][0] - metrics[-1][0])
    print(f"{label}: loss |d| {d_loss:.3g}, params at {wp:.3g} of "
          f"{STEP_LR_FRACTION} lr, m at {wm:.3g} of the bar; rank 0 holds "
          f"{n_block} of {n_whole} elements; bytes {got['traffic']}")


def expected_blocks(cfg, mesh_shape, mode):
    """{name: block shape} of every rank of a (data, model) mesh."""
    class Shape:
        shape = dict(zip(("data", "model"), mesh_shape))
        axis_names = ("data", "model")
    layout = M.init(cfg, device="meta")
    specs = rules.model_specs(layout, Shape, mode)
    out = []
    for d in range(mesh_shape[0]):
        for m in range(mesh_shape[1]):
            coords = {"data": d, "model": m}
            out.append({n: tuple(s.stop - s.start for s in rules.block_slices(
                p.shape, specs[n], Shape, coords))
                for n, p in layout.named_parameters()})
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)],
                         ids=["2x2", "1x4"])
def test_mesh_steps_match_jax(mesh_shape):
    """olmo in every mode and with a loss mask split unevenly over the
    data ranks at n_micro=2; zamba2 (the hybrid's SSM leaves) at 2x2."""
    cfg, hybrid = small("olmo-1b"), small("zamba2-2.7b")
    plain, masked = batches_of(cfg), batches_of(cfg, mask=True)
    cases = [dict(cfg=cfg, mode="tp", batches=plain)]
    if mesh_shape == (2, 2):
        cases += [dict(cfg=cfg, mode="fsdp", batches=plain),
                  dict(cfg=cfg, mode="tp", batches=masked, n_micro=2),
                  dict(cfg=hybrid, mode="tp", batches=batches_of(hybrid))]
    results = run_local(ranks.train_cases, *mesh_shape, args=(cases,),
                        timeout=TIMEOUT)
    for i, case in enumerate(cases):
        runs = [r[i] for r in results]
        label = f"{case['cfg'].name} {mesh_shape} {case['mode']}"
        if "n_micro" in case:
            label += " masked n_micro=2"
            want = jax_run("olmo-1b", masked, n_micro=2)
        else:
            want = jax_run(case["cfg"].name, case["batches"])
        check_run(label, runs, want, mesh_shape)
        assert [r["blocks"] for r in runs] == expected_blocks(
            case["cfg"], mesh_shape, case["mode"])
        # the gradients are summed over the ranks of different rows only
        assert ("grad_reduce" in runs[0]["traffic"]) == (mesh_shape[0] > 1)


def test_mixtral_expert_parallel_matches_jax():
    """moe_shard_map on 1x4: each model rank computes its one packed
    expert row (``layers.moe_apply_shard_map``) under remat dots and full,
    modes tp and ep. ``moe_out`` moves once a layer a step under dots; with
    torch's early stop off, the full recomputation sums it again."""
    over = dict(moe_shard_map=True, remat=True)
    cfg = small("mixtral-8x22b")
    batches = batches_of(cfg)
    cases = [dict(cfg=dataclasses.replace(cfg, **over, remat_policy=policy),
                  mode=mode, batches=batches, early_stop=early)
             for mode, policy, early in (("tp", "dots", True),
                                         ("tp", "full", False),
                                         ("ep", "dots", False),
                                         ("ep", "full", True))]
    results = run_local(ranks.train_cases, 1, 4, args=(cases,),
                        timeout=TIMEOUT)
    want = jax_run("mixtral-8x22b", batches, moe_shard_map=True)
    layer_bytes = ROWS * SEQ * cfg.d_model * 4 * 3     # f32, 3 other ranks
    forward_only = STEPS * cfg.n_layers * layer_bytes
    for i, case in enumerate(cases):
        runs = [r[i] for r in results]
        policy = case["cfg"].remat_policy
        label = (f"mixtral 1x4 {case['mode']} {policy} early stop "
                 f"{case['early_stop']}")
        check_run(label, runs, want, (1, 4))
        assert all(r["ep"] for r in runs)
        for r in runs:
            rows = {n: s for n, s in r["blocks"].items() if ".moe.w_" in n}
            assert rows and all(s[0] == 1 for s in rows.values())
        moved = runs[0]["traffic"]["moe_out"]
        repeat = policy == "full" and not case["early_stop"]
        assert moved == forward_only * (2 if repeat else 1), (label, moved)
        assert runs[0]["traffic"]["moe_in"] > 0


OTHERS = [n for n in ARCH_IDS if n not in ("olmo-1b", "mixtral-8x22b",
                                           "zamba2-2.7b")]


def test_other_architectures_mesh_step_match_the_port():
    cases = [dict(cfg=small(n), mode="tp", batches=batches_of(small(n)))
             for n in OTHERS]
    results = run_local(ranks.train_cases, 2, 2, args=(cases,),
                        timeout=TIMEOUT)
    for i, (name, case) in enumerate(zip(OTHERS, cases)):
        check_run(f"{name} 2x2 tp", [r[i] for r in results],
                  port_run(case["cfg"], case["batches"]), (2, 2))


def test_restore_on_mesh_is_bitwise_and_trains_on(tmp_path):
    """A 2x2 tp state's checkpoint (the leader's whole leaves) restores on
    the same world re-planned 1x4 (fsdp) and 4x1 (tp): every block bitwise
    its slice of the saved leaf, the moments and the step too, and the
    next step's loss that of the 2x2 run's continuation."""
    cfg = small("olmo-1b")
    batches = batches_of(cfg, n=3)
    results = run_local(ranks.restore_and_continue, 2, 2,
                        args=(cfg, batches, str(tmp_path)), timeout=TIMEOUT)
    layout = M.init(cfg, device="meta")
    saved = store.restore(str(tmp_path), 2, {
        "params": convert.params_to_numpy(M.init(cfg, device="cpu")),
        "opt": {"m": convert.params_to_numpy(M.init(cfg, device="cpu")),
                "step": np.zeros((), np.int32)}})
    for r in results:
        for name in ("1x4", "4x1"):
            got = r[name]
            shape = (1, 4) if name == "1x4" else (4, 1)
            mesh = plan_mesh(*shape)
            assert got["specs"] == rules.model_specs(layout, mesh,
                                                     got["mode"])
            for key, tree in (("params", saved["params"]),
                              ("m", saved["opt"]["m"])):
                whole = convert.from_tree(layout, _torch_tree(tree))
                for n, block in got[key].items():
                    sl = rules.block_slices(whole[n].shape, got["specs"][n],
                                            mesh, got["coords"])
                    assert np.array_equal(block, whole[n][sl].numpy()), \
                        (name, key, n)
            assert got["step"] == 2
            np.testing.assert_allclose(got["loss"], r["loss_2x2"],
                                       rtol=1e-6)
        whole = convert.from_tree(layout, _torch_tree(saved["params"]))
        for n, block in r["params_1x4"].items():
            assert np.array_equal(block, r["1x4"]["params"][n])
            assert block.shape != tuple(whole[n].shape) or \
                rules.model_specs(layout, plan_mesh(1, 4), "fsdp")[n] == ()


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def test_one_rank_mesh_step_is_bitwise_the_single_device_step():
    """A 1 x 1 mesh with no process group: every collective moves
    nothing, and the step is the single-device step bit for bit, remat
    and the MoE's plain path included."""
    mesh = make_test_mesh(1, 1, device="cpu")
    shape = InputShape("t", SEQ, ROWS, "train")
    opt_cfg = adamw.AdamWConfig(**ranks.OPT)
    for name, over in (("olmo-1b", dict(remat=True, remat_policy="dots")),
                       ("mixtral-8x22b", dict(moe_shard_map=True)),
                       ("zamba2-2.7b", dict(remat=True))):
        cfg = dataclasses.replace(smoke_config(name), **over)
        model = M.init(cfg, seed=0, device="cpu")
        state = St.MeshTrainState.from_model(model, mesh)
        opt = adamw.init(dict(model.named_parameters()))
        one = St.make_train_step(shape, opt_cfg, n_micro=2)
        step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg,
                                       n_micro=2)
        for b in batches_of(cfg, mask=True):
            b = {k: torch.as_tensor(v) for k, v in b.items()}
            model, opt, m = one(model, opt, b)
            state = step(state, b)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(m[k], state.metrics[k]), (name, k)
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), state.blocks[n]), (name, n)
            assert torch.equal(opt["v"][n], state.opt["v"][n]), (name, n)
        assert not any(getattr(mod, "ep_mesh", None) is not None
                       for mod in state.model.modules())


def test_rank_rows_take_each_microbatch_chunk():
    """A rank's microbatch i is its slice of the global chunk i (JAX's
    accumulate_grads splits the global batch first)."""
    class Coords:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")
        device = torch.device("cpu")

        def __init__(self, d, m):
            self.at = {"data": d, "model": m}

        def index(self, axis):
            return self.at[axis]
    rows = torch.arange(8)[:, None].expand(8, 3)
    got = St.rank_rows({"tokens": rows}, Coords(1, 0), ("data",), 2)
    assert got["tokens"][:, 0].tolist() == [2, 3, 6, 7]
    got = St.rank_rows({"tokens": rows}, Coords(1, 0), ("data", "model"), 2)
    assert got["tokens"][:, 0].tolist() == [2, 6]
    assert St.batch_axes({"tokens": rows}, Coords(0, 0), "fsdp") == \
        ("data", "model")
    assert St.batch_axes({"tokens": rows[:2]}, Coords(0, 0), "fsdp") == \
        ("data",)                          # the rules' fall-back
    with pytest.raises(ValueError, match="n_micro"):
        St.rank_rows({"tokens": rows[:6]}, Coords(0, 0), ("data",), 4)


def test_mesh_state_refuses_what_it_cannot_do():
    cfg = dataclasses.replace(smoke_config("mixtral-8x22b"),
                              moe_shard_map=True)
    with pytest.raises(ValueError, match="replicated over 'model'"):
        St.MeshTrainState.from_blocks(cfg, plan_mesh(1, 4), "fsdp", {})
    mesh = make_test_mesh(1, 1, device="cpu")
    state = St.MeshTrainState.init(smoke_config("olmo-1b"), mesh)
    step = St.make_mesh_train_step(InputShape("t", SEQ, ROWS, "train"),
                                   mesh, mode="fsdp")
    with pytest.raises(ValueError, match="'tp' state"):
        step(state, batches_of(smoke_config("olmo-1b"))[0])
    with pytest.raises(ValueError, match="block"):
        St.MeshTrainState.from_blocks(
            smoke_config("olmo-1b"), mesh, "tp",
            {n: torch.zeros(1) for n in state.blocks})


def test_elastic_plans_the_rules_layout(tmp_path):
    """``reshard_plan`` is the rules' per-block table on a plan or a mesh;
    ``restore_on_mesh`` of a whole-model checkpoint on a one-rank mesh is
    the model bit for bit (the LM pieces no longer wait)."""
    cfg = smoke_config("olmo-1b")
    model = M.init(cfg, seed=3, device="cpu")
    for shape, mode in (((2, 2), "tp"), ((1, 4), "fsdp"), ((4, 1), "ep")):
        plan = plan_mesh(*shape)
        assert elastic.reshard_plan(model, plan, mode) == \
            rules.model_specs(model, plan, mode)
    store.save(str(tmp_path), 7, convert.to_tree(
        model, {n: p.detach() for n, p in model.named_parameters()}))
    blocks = elastic.restore_on_mesh(str(tmp_path), 7, model,
                                     make_test_mesh(1, 1, device="cpu"))
    assert all(torch.equal(blocks[n], p.detach())
               for n, p in model.named_parameters())
    state = St.MeshTrainState.init(cfg, make_test_mesh(1, 1, device="cpu"))
    state.save(str(tmp_path / "state"), 0)
    back = elastic.restore_on_mesh(str(tmp_path / "state"), 0, state,
                                   make_test_mesh(1, 1, device="cpu"))
    assert isinstance(back, St.MeshTrainState) and back.mode == "tp"
    assert all(torch.equal(back.blocks[n], state.blocks[n])
               for n in state.blocks)
    assert os.path.exists(tmp_path / "state" / "step_00000000")
