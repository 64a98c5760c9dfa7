"""Deterministic chaos injection for the serving runtime.

One seeded :class:`ChaosSchedule` describes every fault up front — which
device-launch attempts raise, which are slowed by an injected straggler
delay, and which checkpoint leaves get corrupted — so a chaos run is a
pure function of (schedule, traffic): tests assert exact tier sequences
and bit-identical results, and re-running the same schedule reproduces
the same served-tier mix (the acceptance criterion's "all deterministic
under fixed seeds").

:class:`ChaosInjector` is the live half: it plugs into
``EmdServer(launch_hook=...)`` and counts every launch ATTEMPT (retries
included), raising :class:`FaultInjected` or sleeping per the schedule.
``corrupt_checkpoint`` flips bytes in a saved snapshot's leaf files so
restore-path tests exercise the typed ``CheckpointCorrupt`` fallback.

The port's copy of the JAX package's ``serving/chaos.py`` (numpy only): a
seed gives the same schedule in both packages. Used by
``tests/test_torch_serving.py`` and ``chip_smoke.py``'s phase 10.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np


class FaultInjected(RuntimeError):
    """The injected launch failure (stands in for a device launch error /
    lost node; the server's retry + degradation path treats it like any
    other launch exception)."""


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Faults keyed by global launch-attempt index (0-based, counted
    across ALL tiers and retries in arrival order).

    fail_launches:  attempt indices that raise :class:`FaultInjected`.
    delay_launches: attempt index -> injected latency in seconds (a
                    straggler: the launch succeeds but slowly, which
                    feeds the server's tier-latency estimate and can
                    trigger deadline-pressure degradation).
    corrupt_leaves: leaf names to corrupt in ``corrupt_checkpoint``.
    seed:           the generating seed (bookkeeping only).
    """
    fail_launches: frozenset[int] = frozenset()
    delay_launches: tuple[tuple[int, float], ...] = ()
    corrupt_leaves: tuple[str, ...] = ()
    seed: int | None = None

    @classmethod
    def from_seed(cls, seed: int, horizon: int, p_fail: float = 0.1,
                  p_delay: float = 0.0,
                  delay_s: float = 0.05) -> "ChaosSchedule":
        """Bernoulli fail/delay draws per attempt over ``horizon``
        attempts — same seed, same schedule, byte for byte."""
        rng = np.random.default_rng(seed)
        draws = rng.random((horizon, 2))
        fails = frozenset(int(i) for i in np.nonzero(
            draws[:, 0] < p_fail)[0])
        delays = tuple((int(i), delay_s) for i in np.nonzero(
            (draws[:, 1] < p_delay))[0] if int(i) not in fails)
        return cls(fail_launches=fails, delay_launches=delays, seed=seed)


class ChaosInjector:
    """Launch hook executing a :class:`ChaosSchedule`.

    Contract (``EmdServer`` launch_hook): called as
    ``hook(launch_fn, tier, q_ids, q_w)`` for every attempt; must either
    return ``launch_fn(tier, q_ids, q_w)`` or raise. Keeps a log of
    (attempt index, tier name, outcome) for assertions.
    """

    def __init__(self, schedule: ChaosSchedule,
                 sleep_fn=time.sleep) -> None:
        self.schedule = schedule
        self.attempts = 0
        self.log: list[tuple[int, str, str]] = []
        self._delays = dict(schedule.delay_launches)
        self._sleep = sleep_fn

    def __call__(self, launch_fn, tier, q_ids, q_w):
        i = self.attempts
        self.attempts += 1
        if i in self.schedule.fail_launches:
            self.log.append((i, tier.name, "fail"))
            raise FaultInjected(f"injected launch failure #{i} "
                                f"(tier {tier.name})")
        if i in self._delays:
            self.log.append((i, tier.name, "delay"))
            self._sleep(self._delays[i])
        else:
            self.log.append((i, tier.name, "ok"))
        return launch_fn(tier, q_ids, q_w)


def corrupt_checkpoint(ckpt_path: str, leaves: tuple[str, ...] = (),
                       seed: int = 0) -> list[str]:
    """Flip one byte in each named leaf file of a saved checkpoint
    directory (every ``.npy`` when ``leaves`` is empty); returns the
    files touched. The manifest is left intact — exactly the corruption
    SHA-256 verification exists to catch (``store.CheckpointCorrupt``).
    """
    rng = np.random.default_rng(seed)
    names = leaves or tuple(sorted(
        f for f in os.listdir(ckpt_path) if f.endswith(".npy")))
    touched = []
    for name in names:
        fname = name if name.endswith(".npy") else name + ".npy"
        path = os.path.join(ckpt_path, fname)
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            pos = int(rng.integers(0, len(data)))
            data[pos] ^= 0xFF
            f.seek(0)
            f.write(data)
        touched.append(path)
    return touched
