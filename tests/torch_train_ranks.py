"""Rank bodies of the LM mesh training tests (``test_torch_mesh_train.py``).

``repro_torch.launch.local.run_local`` runs each function on every rank of
a local gloo mesh on the CPU. They import only the port (never JAX): each
rank draws the model from seed 0 (``MeshTrainState.init``, the same
weights as ``models.model.init`` in the test process), runs the mesh step
on the global numpy batches it is given and returns numpy results; the
test process holds them to the JAX package's single-device step and to the
port's own.
"""
import os

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.launch import mesh as Mx
from repro_torch.launch import steps as St
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.sharding import annotate

#: The AdamW settings of every mesh run (test_torch_train's).
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _np(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().float().numpy()


def train(mesh, cfg, mode, batches, n_micro=1, early_stop=True):
    """``len(batches)`` mesh steps from seed 0 -> {"metrics": [(loss,
    grad norm, lr)], "tree": the leader's whole state (numpy; None
    elsewhere), "blocks" / "moments": this rank's block shapes, "specs",
    "traffic": bytes by label, "ep": whether the experts ran locally}."""
    rows = len(next(iter(batches[0].values())))
    seq = next(iter(batches[0].values())).shape[1]
    step = St.make_mesh_train_step(InputShape("t", seq, rows, "train"), mesh,
                                   mode=mode,
                                   opt_cfg=adamw.AdamWConfig(**OPT),
                                   n_micro=n_micro)
    state = St.MeshTrainState.init(cfg, mesh, mode, seed=0)
    metrics = []
    annotate.reset_traffic()
    with ckpt.set_checkpoint_early_stop(early_stop):
        for b in batches:
            state = step(state, b)
            metrics.append(tuple(float(state.metrics[k])
                                 for k in ("loss", "grad_norm", "lr")))
    traffic = annotate.traffic()
    return {"metrics": metrics, "tree": _np(state.tree()),
            "blocks": {n: tuple(b.shape) for n, b in state.blocks.items()},
            "moments": {n: tuple(b.shape) for n, b in state.opt["m"].items()},
            "specs": state.specs, "traffic": traffic,
            "ep": any(getattr(m, "ep_mesh", None) is not None
                      for m in state.model.modules())}


def train_cases(mesh, cases):
    """``train`` for each case (a dict of its keyword arguments)."""
    return [train(mesh, **case) for case in cases]


def restore_and_continue(mesh, cfg, batches, ckpt_dir):
    """On a 2x2 world: two tp steps, a checkpoint from the leader, a
    third step on 2x2; then the same world re-planned as 1x4 and 4x1
    (``plan_mesh`` / ``join_mesh``): ``restore_on_mesh`` of the checkpoint
    (mode fsdp on 1x4, tp on 4x1) and the third step there. Returns this
    rank's blocks on each new mesh (numpy) and the third step's losses,
    with the parameter-only checkpoint's blocks on 1x4."""
    shape = InputShape("t", batches[0]["tokens"].shape[1],
                       len(batches[0]["tokens"]), "train")
    opt_cfg = adamw.AdamWConfig(**OPT)
    state = St.MeshTrainState.init(cfg, mesh, "tp", seed=0)
    step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg, n_micro=1)
    for b in batches[:2]:
        state = step(state, b)
    state.save(ckpt_dir, 2)
    tree = state.tree()
    if tree is not None:
        from repro_torch.checkpoint import store
        store.save(os.path.join(ckpt_dir, "params"), 2, tree["params"])
    out = {"loss_2x2": float(step(state, batches[2]).metrics["loss"])}
    meshes = {"1x4": ("fsdp", Mx.join_mesh(Mx.plan_mesh(1, 4))),
              "4x1": ("tp", Mx.join_mesh(Mx.plan_mesh(4, 1)))}
    for name, (mode, new_mesh) in meshes.items():
        restored = elastic.restore_on_mesh(ckpt_dir, 2, state, new_mesh,
                                           mode)
        out[name] = {
            "mode": mode,
            "coords": {a: new_mesh.index(a) for a in Mx.AXES},
            "specs": elastic.reshard_plan(state, new_mesh, mode),
            "params": {n: b.detach().numpy().copy()
                       for n, b in restored.blocks.items()},
            "m": {n: b.numpy().copy() for n, b in restored.opt["m"].items()},
            "step": int(restored.opt["step"])}
        new_step = St.make_mesh_train_step(shape, new_mesh, mode=mode,
                                           opt_cfg=opt_cfg, n_micro=1)
        out[name]["loss"] = float(new_step(restored, batches[2])
                                  .metrics["loss"])
    blocks = elastic.restore_on_mesh(os.path.join(ckpt_dir, "params"), 2,
                                     state.layout, meshes["1x4"][1], "fsdp")
    out["params_1x4"] = {n: b.numpy().copy() for n, b in blocks.items()}
    return out


def one_rank_against_one_device(mesh, cfg, batches):
    """On a one-rank mesh: the mesh step and the single-device step from
    the same seed-0 weights on the same batches; whether every metric,
    parameter and moment is bitwise equal."""
    from repro_torch.models import model as M
    shape = InputShape("t", batches[0]["tokens"].shape[1],
                       len(batches[0]["tokens"]), "train")
    opt_cfg = adamw.AdamWConfig(**OPT)
    model = M.init(cfg, seed=0, device=mesh.device)
    state = St.MeshTrainState.from_model(model, mesh)
    opt = adamw.init(dict(model.named_parameters()))
    mesh_step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg,
                                        n_micro=1)
    one_step = St.make_train_step(shape, opt_cfg, n_micro=1)
    metrics = []
    for b in batches:
        state = mesh_step(state, b)
        model, opt, m = one_step(model, opt, b)
        metrics.append(all(torch.equal(m[k], state.metrics[k]) for k in m))
    return {"metrics": metrics,
            "params": all(torch.equal(p.detach(), state.blocks[n])
                          for n, p in model.named_parameters()),
            "moments": all(torch.equal(opt[k][n], state.opt[k][n])
                           for k in ("m", "v") for n in opt[k])}
