"""The port's fault-tolerant runner (``runtime/fault.py``): the JAX
package's ``tests/test_fault.py`` cases on the port, then training through
failures (``launch.steps.TrainState``) bitwise the failure-free run, and
checkpoints crossing between the two packages' runners: a run checkpointed
by JAX's runner resumed by the port's, and the other way round, each
training on to within rtol 1e-4 of the other package's own losses.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as JSt
from repro.models import model as JM
from repro.models.config import InputShape as JInputShape
from repro.optim import adamw as JA
from repro.runtime.fault import FaultTolerantRunner as JaxRunner
from repro_torch.configs import smoke_config
from repro_torch.data.tokens import DataConfig, global_batch, shard_batch
from repro_torch.launch import steps as St
from repro_torch.models import model as M
from repro_torch.models import parity
from repro_torch.models.config import InputShape
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (TIME_WINDOW, FaultTolerantRunner,
                                       StragglerStats)


def _step(state, batch):
    return {"w": state["w"] + torch.sum(batch["tokens"] % 7).float(),
            "n": state["n"] + 1}


def _data(step):
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=4, seed=1)
    return {"tokens": torch.as_tensor(global_batch(cfg, step)["tokens"])}


def _init():
    return {"w": torch.tensor(0.0), "n": torch.tensor(0, dtype=torch.int32)}


def _flaky(fail_at):
    def flaky(state, batch):
        step = int(state["n"])
        if step in fail_at:            # the FIRST time each step is hit
            fail_at.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")
        return _step(state, batch)
    return flaky


def test_recovery_reproduces_failure_free_run(tmp_path):
    ref = FaultTolerantRunner(_step, _data, str(tmp_path / "clean"),
                              ckpt_every=5).run(_init(), 23)
    runner = FaultTolerantRunner(_flaky({3, 11, 12, 19}), _data,
                                 str(tmp_path / "flaky"), ckpt_every=5)
    out = runner.run(_init(), 23)
    assert runner.restarts == 4
    assert int(out["n"]) == int(ref["n"]) == 23
    assert float(out["w"]) == float(ref["w"])   # bit-identical replay


def test_resume_from_disk(tmp_path):
    d = str(tmp_path / "resume")
    FaultTolerantRunner(_step, _data, d, ckpt_every=5).run(_init(), 10)
    # a new runner picks up from the checkpoint, not from scratch
    seen = []
    out = FaultTolerantRunner(_step, _data, d, ckpt_every=5).run(
        _init(), 15, on_step=lambda s, _: seen.append(s))
    assert seen == [11, 12, 13, 14, 15]
    ref = FaultTolerantRunner(_step, _data, str(tmp_path / "ref"),
                              ckpt_every=5).run(_init(), 15)
    assert float(out["w"]) == float(ref["w"])


def test_straggler_flagging():
    st = StragglerStats()
    for i in range(20):
        assert not st.record(i, 1.0, factor=3.0)
    assert st.record(20, 10.0, factor=3.0)
    assert st.flagged_steps == [20]


def test_data_pipeline_deterministic_and_shardable():
    cfg = DataConfig(vocab=50, seq_len=16, global_batch=8, seed=4, n_shards=4)
    a = shard_batch(cfg, step=3, shard=2)
    b = shard_batch(cfg, step=3, shard=2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    g = global_batch(cfg, step=3)
    assert g["tokens"].shape == (8, 16)
    np.testing.assert_array_equal(g["tokens"][4:6], a["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_straggler_times_window_is_bounded():
    st = StragglerStats()
    for i in range(10 * TIME_WINDOW):
        st.record(i, 1.0, factor=3.0)
    assert len(st.times) == TIME_WINDOW
    for i in range(TIME_WINDOW):
        st.record(1000 + i, 9.0, factor=3.0)
    assert not st.record(5000, 9.0, factor=3.0)


def test_replayed_steps_excluded_from_straggler_stats(tmp_path):
    """Every successful step is timed exactly once despite 4 rollbacks."""
    runner = FaultTolerantRunner(_flaky({3, 11, 12, 19}), _data,
                                 str(tmp_path / "flaky"), ckpt_every=5)
    runner.run(_init(), 23)
    assert runner.restarts == 4
    assert len(runner.straggler.times) == 23
    clean = FaultTolerantRunner(_step, _data, str(tmp_path / "clean"),
                                ckpt_every=5)
    clean.run(_init(), 23)
    assert len(clean.straggler.times) == 23


def test_max_restarts_raises(tmp_path):
    def always(state, batch):
        raise RuntimeError("down")
    runner = FaultTolerantRunner(always, _data, str(tmp_path / "r"),
                                 max_restarts=2)
    with pytest.raises(RuntimeError, match="down"):
        runner.run(_init(), 3)
    assert runner.restarts == 3


@pytest.mark.parametrize("name", ["olmo-1b", "mixtral-8x22b"])
def test_training_through_failures_is_bitwise(tmp_path, name):
    """30 smoke steps with failures at steps 7 and 18 (rolled back to the
    checkpoints of steps 5 and 15): parameters, moments and step counter
    bitwise those of the failure-free run, and the loss falls."""
    restarts, losses = parity.replay_bitwise(smoke_config(name), "cpu",
                                             str(tmp_path))
    assert restarts == 2 and len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

ARCH, SEQ, BATCH, MID, END = "olmo-1b", 16, 2, 10, 15
OPT = dict(peak_lr=3e-3, warmup_steps=5, total_steps=END)
DC = DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=0)


def jax_run(ckpt_dir, n_steps, seed=0):
    """JAX's runner over JAX's train step: the losses of the steps run."""
    jcfg = jax_smoke_config(ARCH)
    step = jax.jit(JSt.make_train_step(jcfg, JInputShape("t", SEQ, BATCH,
                                                         "train"),
                                       JA.AdamWConfig(**OPT), n_micro=1))
    params = JM.init(jax.random.PRNGKey(seed), jcfg)
    losses = []

    def fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    state = JaxRunner(fn, lambda n: {k: jnp.asarray(v) for k, v in
                                     global_batch(DC, n).items()},
                      ckpt_dir, ckpt_every=5).run(
        {"params": params, "opt": JA.init(params)}, n_steps)
    return losses, state


def port_run(ckpt_dir, n_steps, seed=0):
    """The port's runner over its train step: (losses, final state)."""
    cfg = smoke_config(ARCH)
    step = St.runner_step(St.make_train_step(
        InputShape("t", SEQ, BATCH, "train"), adamw.AdamWConfig(**OPT),
        n_micro=1))
    model = M.init(cfg, seed=seed, device="cpu")
    losses = []

    def fn(state, batch):
        state = step(state, batch)
        losses.append(float(state.metrics["loss"]))
        return state

    state = FaultTolerantRunner(
        fn, lambda n: {k: torch.as_tensor(v) for k, v in
                       global_batch(DC, n).items()},
        ckpt_dir, ckpt_every=5).run(
        St.TrainState(model, adamw.init(dict(model.named_parameters()))),
        n_steps)
    return losses, state


def test_port_resumes_a_checkpoint_of_jax_runner(tmp_path):
    """JAX's runner trains to step 10; the port's runner, whose model
    starts from other weights, resumes from that checkpoint and trains to
    15 with JAX's own losses of steps 11-15 (rtol 1e-4)."""
    jax_run(str(tmp_path / "jax"), MID)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    want, jstate = jax_run(str(tmp_path / "jax"), END)
    got, state = port_run(str(tmp_path / "port"), END, seed=5)
    assert len(got) == len(want) == END - MID
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(state.opt["step"]) == int(jstate["opt"]["step"]) == END


def test_jax_resumes_a_checkpoint_of_the_port_runner(tmp_path):
    port_run(str(tmp_path / "port"), MID)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    want, state = port_run(str(tmp_path / "port"), END)
    got, jstate = jax_run(str(tmp_path / "jax"), END, seed=5)
    assert len(got) == len(want) == END - MID
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(jstate["opt"]["step"]) == int(state.opt["step"]) == END
