"""End-to-end training example on the PyTorch/CUDA port: the train loop
with checkpoint / restart, an injected failure and straggler tracking, on
one device.

Trains the reduced olmo-family model (``smoke_config``) for a few hundred
steps on the deterministic synthetic token pipeline; the loss must drop.
A node failure is injected at step 77 and recovered from the last
checkpoint, whose replay is bit-identical (deterministic data). The same
flow and flags as the JAX package's ``examples/train_lm.py``, plus
``--device``; its mesh option waits for the port's LM mesh slice.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
     [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.tokens import DataConfig, global_batch
from repro_torch.launch import steps as St
from repro_torch.models import model as M
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultTolerantRunner


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
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(f"device={device}: one device; training on a (data, model) mesh "
          "waits for the port's LM mesh slice")

    cfg = smoke_config(args.arch)
    shape = InputShape("train", 64, 8, "train")
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=20,
                                total_steps=args.steps)
    train_step = St.make_train_step(shape, opt_cfg=opt_cfg)
    model = M.init(cfg, seed=0, device=device)
    opt = adamw.init(dict(model.named_parameters()), cfg.opt_state_dtype)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)

    losses = []
    failed = {"done": False}
    step = St.runner_step(train_step)

    def wrapped(state, batch):
        if (not failed["done"]
                and int(state.opt["step"]) == args.fail_at):
            failed["done"] = True
            raise RuntimeError("injected node failure")
        state = step(state, batch)
        losses.append(float(state.metrics["loss"]))
        return state

    def batch_for(n: int):
        return {k: torch.as_tensor(v, device=device)
                for k, v in global_batch(dc, n).items()}

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_ckpt_")
    runner = FaultTolerantRunner(wrapped, batch_for, ckpt, ckpt_every=25)
    state = runner.run(St.TrainState(model, opt), args.steps)

    print(f"restarts={runner.restarts} "
          f"straggler-flagged={len(runner.straggler.flagged_steps)}")
    k = max(len(losses) // 10, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"loss {first:.3f} -> {last:.3f} over {int(state.opt['step'])} "
          f"steps (ckpts in {ckpt})")
    assert last < first - 0.2, "training did not improve loss"
    print("OK")


if __name__ == "__main__":
    main()
