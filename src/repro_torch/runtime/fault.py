"""Fault tolerance: a checkpointed step loop with failure recovery and
straggler tracking (the JAX package's ``runtime/fault.py``).

``FaultTolerantRunner`` wraps any (state, batch) -> state step function:
  * checkpoints every ``ckpt_every`` steps (atomic, ``checkpoint/store``);
  * on a step failure (a lost device or process, a preemption, surfaced
    as an exception), rolls back to the last checkpoint and replays; the
    deterministic data pipeline (``data/tokens.py``) makes the replayed
    batches bit-identical;
  * tracks each step's wall time; steps slower than ``straggler_factor`` x
    the running median are recorded. Failed and REPLAYED steps are kept
    out of the timing: a replay runs against warm caches and a failed
    attempt measured the failure, so either would bias the median that
    the flagging threshold compares against.

The state is a tree of tensors (dicts and lists, as ``checkpoint/store``
saves them), or an object with ``tree()`` and ``load_tree(tree)`` such as
``launch.steps.TrainState``: its checkpoint is ``tree()``, the parameters
and AdamW state in the JAX package's layout, so a checkpoint written by
either package's runner resumes in the other, and a restore writes the
tree back into the model with ``load_tree``. A state with ``save(ckpt_dir,
step, extra)`` and ``restore(ckpt_dir, step)`` checkpoints itself: a
``launch.steps.MeshTrainState``, whose leader writes the gathered tree
and whose every rank reads back its blocks. On a mesh every rank runs
the loop, failures included, in step.

Failures are injected here by tests and by the training example; a
cluster's runtime would raise them from a lost heartbeat.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import deque
from collections.abc import Callable
from typing import Any

from repro_torch.checkpoint import store

#: Sliding window of per-step wall times kept for the straggler median;
#: ``StragglerStats.times`` never grows past it.
TIME_WINDOW = 64


@dataclasses.dataclass
class StragglerStats:
    times: deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=TIME_WINDOW))
    flagged_steps: list[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float, factor: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > factor * med:
                self.flagged_steps.append(step)
                return True
        return False


def _tree(state: Any) -> Any:
    return state.tree() if hasattr(state, "tree") else state


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable[[Any, Any], Any],
                 batch_fn: Callable[[int], Any], ckpt_dir: str,
                 ckpt_every: int = 10, max_restarts: int = 16,
                 straggler_factor: float = 3.0):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = StragglerStats()
        self.straggler_factor = straggler_factor
        self.restarts = 0
        # High-water mark of steps whose timing was recorded: steps at or
        # below it are rollback replays and must not re-enter the stats.
        self._timed_through = 0

    def _save(self, state: Any, step: int) -> None:
        extra = {"wall": time.time()}
        if hasattr(state, "save"):
            state.save(self.ckpt_dir, step, extra)
        else:
            store.save(self.ckpt_dir, step, _tree(state), extra=extra)

    def _resume_point(self, state: Any) -> tuple[Any, int]:
        last = store.latest_step(self.ckpt_dir)
        if last is None:
            return state, 0
        if hasattr(state, "restore"):
            return state.restore(self.ckpt_dir, last), last
        tree = store.restore(self.ckpt_dir, last, _tree(state))
        if hasattr(state, "load_tree"):
            return state.load_tree(tree), last
        return tree, last

    def run(self, state: Any, n_steps: int,
            on_step: Callable[[int, Any], None] | None = None) -> Any:
        """Run to ``n_steps`` in all, resuming and replaying through
        failures."""
        state, step = self._resume_point(state)
        if step == 0:
            self._save(state, 0)
        while step < n_steps:
            try:
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                state = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                step += 1
                if step > self._timed_through:       # first attempt only
                    self.straggler.record(step, dt, self.straggler_factor)
                    self._timed_through = step
                if on_step is not None:
                    on_step(step, state)
                if step % self.ckpt_every == 0:
                    self._save(state, step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self._resume_point(state)
        self._save(state, step)
        return state
