"""End-to-end training example on the PyTorch/CUDA port: the train loop
with checkpoint / restart, an injected failure and straggler tracking, on
one device or on a (data, model) mesh.

Trains the reduced olmo-family model (``smoke_config``) for a few hundred
steps on the deterministic synthetic token pipeline; the loss must drop.
A node failure is injected at step 77 and recovered from the last
checkpoint, whose replay is bit-identical (deterministic data). The same
flow and flags as the JAX package's ``examples/train_lm.py``, plus
``--device``.

With ``--mesh DxM`` the loop runs on every rank of a local gloo world of
D x M processes (``launch.local.run_local``; on the CPU, or sharing the
card with ``--device cuda``): the mesh train step
(``launch.steps.make_mesh_train_step``, mode tp) under a
``FaultTolerantRunner`` whose checkpoints the leader writes and whose
restore reads each rank's blocks back (``runtime.elastic``), then the same
run without the failure; every rank's final parameters, moments and step
must be bitwise the failure-free run's.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
     [--device cpu] [--ckpt-dir DIR] [--mesh 2x2]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.tokens import DataConfig, global_batch
from repro_torch.launch import steps as St
from repro_torch.launch.local import run_local
from repro_torch.models import model as M
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultTolerantRunner

#: Tokens a row and rows of the global batch.
SEQ, ROWS = 64, 8
CKPT_EVERY = 25


def _setup(args):
    cfg = smoke_config(args["arch"])
    shape = InputShape("train", SEQ, ROWS, "train")
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=20,
                                total_steps=args["steps"])
    dc = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=ROWS, seed=0)
    return cfg, shape, opt_cfg, dc


def _run(state, step, batch_for, ckpt_dir, n_steps, fail_at):
    """``n_steps`` of ``step`` under a runner, failing once at ``fail_at``
    (None: never). Returns (state, runner, the losses of the steps run)."""
    losses = []
    failed = {"done": fail_at is None}

    def wrapped(state, batch):
        if not failed["done"] and int(state.opt["step"]) == fail_at:
            failed["done"] = True
            raise RuntimeError("injected node failure")
        state = step(state, batch)
        losses.append(float(state.metrics["loss"]))
        return state

    runner = FaultTolerantRunner(wrapped, batch_for, ckpt_dir,
                                 ckpt_every=CKPT_EVERY)
    return runner.run(state, n_steps), runner, losses


def mesh_rank(mesh, args: dict, ckpt: str) -> dict:
    """One rank of ``--mesh``: the run with the failure, then the run
    without it; whether this rank's final blocks, moments and step are
    bitwise equal between the two."""
    cfg, shape, opt_cfg, dc = _setup(args)
    step = St.make_mesh_train_step(shape, mesh, opt_cfg=opt_cfg, n_micro=1)

    def batch_for(n: int):
        return {k: torch.as_tensor(v) for k, v in global_batch(dc, n).items()}
    runs = []
    for name, fail_at in (("run", args["fail_at"]), ("clean", None)):
        state = St.MeshTrainState.init(cfg, mesh, seed=0)
        runs.append(_run(state, step, batch_for, os.path.join(ckpt, name),
                         args["steps"], fail_at))
    (state, runner, losses), (clean, _, _) = runs
    same = [torch.equal(state.blocks[n], clean.blocks[n])
            and torch.equal(state.opt[k][n], clean.opt[k][n])
            for n in state.blocks for k in ("m", "v")]
    return {"restarts": runner.restarts,
            "flagged": len(runner.straggler.flagged_steps), "losses": losses,
            "steps": int(state.opt["step"]),
            "bitwise": all(same) and torch.equal(state.opt["step"],
                                                 clean.opt["step"]),
            "block_elems": sum(b.numel() for b in state.blocks.values()),
            "elems": sum(p.numel() for p in state.layout.parameters())}


def _loss_drop(losses, steps, where) -> None:
    k = max(len(losses) // 10, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"loss {first:.3f} -> {last:.3f} over {steps} steps ({where})")
    assert last < first - 0.2, "training did not improve loss"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--fail-at", type=int, default=77)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                    "one)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a local gloo mesh of D data x M model "
                    "ranks (the sharding rules' mode tp)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_ckpt_")
    if args.mesh:
        n_data, n_model = (int(x) for x in args.mesh.lower().split("x"))
        print(f"mesh=({n_data} data, {n_model} model) over gloo, "
              f"{n_data * n_model} ranks on {device}, mode tp")
        ranks = run_local(mesh_rank, n_data, n_model, backend="gloo",
                          device=device, args=(vars(args), ckpt),
                          timeout=600.0)
        r0 = ranks[0]
        print(f"restarts={r0['restarts']} "
              f"straggler-flagged={r0['flagged']}")
        print(f"each rank holds {r0['block_elems']} of the model's "
              f"{r0['elems']} parameters")
        _loss_drop(r0["losses"], r0["steps"], f"ckpts in {ckpt}")
        assert all(r["restarts"] == 1 for r in ranks)
        assert all(r["bitwise"] for r in ranks), \
            "the replayed run differs from the failure-free one"
        print("final state bitwise the failure-free mesh run on every rank "
              "(parameters, moments, step)")
        print("OK")
        return
    print(f"device={device}: one device")
    cfg, shape, opt_cfg, dc = _setup(vars(args))
    train_step = St.make_train_step(shape, opt_cfg=opt_cfg)
    model = M.init(cfg, seed=0, device=device)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)

    def batch_for(n: int):
        return {k: torch.as_tensor(v, device=device)
                for k, v in global_batch(dc, n).items()}
    state, runner, losses = _run(St.TrainState(model, opt),
                                 St.runner_step(train_step), batch_for, ckpt,
                                 args.steps, args.fail_at)
    print(f"restarts={runner.restarts} "
          f"straggler-flagged={len(runner.straggler.flagged_steps)}")
    _loss_drop(losses, int(state.opt["step"]), f"ckpts in {ckpt}")
    print("OK")


if __name__ == "__main__":
    main()
