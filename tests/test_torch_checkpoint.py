"""The port's checkpoints and fault-tolerant loop on the CPU: the
reference's own tests (``tests/test_checkpoint.py``) ported — roundtrip,
commit marker, async wait, a missing checkpoint raises, restart replays
exactly, exceeding max restarts raises, resume from an existing
directory, the straggler monitor — and the two packages reading each
other's checkpoints: what the reference's ``ckpt.save`` writes restores
through the port's ``ckpt`` (and ``convert.train_state`` for a training
state) leaf for leaf and bitwise, bf16 leaves included, and the reverse.

R9 (ROADMAP.md queue 3): a failure before the first checkpoint makes the
reference's ``run`` replay steps 0.. on the state trained so far; the
port's ``run`` restarts from the initial state.  Losses are compared
exactly where a replay must reproduce them (the same program on the same
state and batch is deterministic on the CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get as ref_get
from repro.configs.shapes import ShapeSpec as RefShape
from repro.models import build as ref_build
from repro.runtime import DriverConfig as RefDriverConfig
from repro.runtime import run as ref_run
from repro.train import AdamW as RefAdamW
from repro.train import SyntheticLM as RefSyntheticLM
from repro.train import constant_schedule as ref_constant
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import build
from repro_torch.runtime import (DriverConfig, SimulatedFailure,
                                 StragglerMonitor, run)
from repro_torch.train import (AdamW, SyntheticLM, constant_schedule,
                               init_state, make_train_step)
from repro_torch.train.optimizer import tree_leaves
from test_torch_models import CTX


def small_state():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.tensor([1.0, -2.5, 3e-3, 65504.0, 1e-8],
                                     dtype=torch.bfloat16),
                   "c": torch.zeros((), dtype=torch.int32)},
    }


def ref_small_state():
    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "nested": {"b": jnp.asarray([1.0, -2.5, 3e-3, 65504.0, 1e-8],
                                    jnp.bfloat16),
                   "c": jnp.zeros((), jnp.int32)},
    }


def _bits(t):
    """A leaf's bytes (bf16 as its 16 bits) and dtype name."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        return t.numpy().tobytes(), str(t.numpy().dtype)
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16).tobytes(), "bfloat16"
    return a.tobytes(), str(a.dtype)


class TestCkpt:
    def test_roundtrip(self, tmp_path):
        state = small_state()
        ckpt.save(state, 3, str(tmp_path))
        restored, step = ckpt.restore(str(tmp_path), target=state)
        assert step == 3
        for x, y in zip(tree_leaves(state), tree_leaves(restored)):
            assert x.dtype == y.dtype and _bits(x) == _bits(y)

    def test_latest_and_commit_marker(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(small_state(), 1, d)
        ckpt.save(small_state(), 5, d)
        assert ckpt.latest_step(d) == 5
        # uncommitted checkpoints are ignored
        os.remove(os.path.join(d, "step_00000005", "_COMMITTED"))
        assert ckpt.latest_step(d) == 1

    def test_async_save_then_wait(self, tmp_path):
        ckpt.save(small_state(), 0, str(tmp_path), asynchronous=True)
        ckpt.wait()
        assert ckpt.latest_step(str(tmp_path)) == 0

    def test_restore_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ckpt.restore(str(tmp_path), target=small_state())


class TestAcrossPackages:
    def test_reference_checkpoint_restores_in_port(self, tmp_path):
        ref_ckpt.save(ref_small_state(), 4, str(tmp_path))
        got, step = ckpt.restore(str(tmp_path), target=small_state())
        assert step == 4
        for x, y in zip(tree_leaves(got),
                        jax.tree.leaves(ref_small_state())):
            assert _bits(x) == _bits(y)

    def test_port_checkpoint_restores_in_reference(self, tmp_path):
        ckpt.save(small_state(), 6, str(tmp_path))
        got, step = ref_ckpt.restore(str(tmp_path), target=jax.eval_shape(
            ref_small_state))
        assert step == 6
        for x, y in zip(jax.tree.leaves(got), tree_leaves(small_state())):
            assert _bits(x) == _bits(y)

    @pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
    def test_train_state_both_ways(self, arch, tmp_path):
        """A reference training state (stacked for smollm-360m, per layer
        for recurrentgemma-2b; error feedback on) saved by the reference
        restores through ``ckpt.load`` and ``convert.train_state`` leaf for
        leaf; the port's, saved through ``convert.to_reference``, restores
        in the reference."""
        ref_cfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
        ref_state = jax.jit(lambda: jax.tree.map(
            lambda a: a + 0.5 if a.ndim else a + 7, ref_init_state(
                ref_build(ref_cfg), jax.random.PRNGKey(3),
                RefAdamW(learning_rate=ref_constant(0.1)), compress=True)))()
        want = convert.train_state(cfg, jax.tree.map(np.asarray, ref_state),
                                   device="cpu")
        ref_ckpt.save(ref_state, 2, str(tmp_path / "ref"))
        tree, step = ckpt.load(str(tmp_path / "ref"))
        got = convert.train_state(cfg, tree, device="cpu")
        assert step == 2 and int(got.opt.step) == 7
        for x, y in zip(tree_leaves(got.params) + tree_leaves(got.opt.mu)
                        + tree_leaves(got.opt.nu)
                        + tree_leaves(got.error_fb),
                        tree_leaves(want.params) + tree_leaves(want.opt.mu)
                        + tree_leaves(want.opt.nu)
                        + tree_leaves(want.error_fb)):
            assert _bits(x) == _bits(y)

        ckpt.save(convert.to_reference(cfg, got), 9, str(tmp_path / "port"))
        back, step = ref_ckpt.restore(str(tmp_path / "port"),
                                      target=jax.eval_shape(lambda: ref_state))
        assert step == 9
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
            assert _bits(x) == _bits(y)


def _setup(seed=0):
    cfg = get("smollm-360m").reduced()
    model = build(cfg)
    opt = AdamW(learning_rate=constant_schedule(3e-3))
    state = init_state(model, torch.Generator().manual_seed(seed), opt)
    src = SyntheticLM(cfg, ShapeSpec("t", 16, 8, "train"))
    return (state, make_train_step(model, opt),
            lambda s: src.place(src.batch_for_step(s), "cpu"))


def _recorder():
    losses = {}

    def on_step(s, m):
        losses.setdefault(s, []).append(float(m["loss"]))
    return losses, on_step


class TestFaultTolerantDriver:
    def test_failure_restart_replays_exactly(self, tmp_path):
        state, step_fn, batch_fn = _setup()
        cfg = DriverConfig(total_steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                           fail_at_steps=(5,), async_ckpt=False)
        losses, on_step = _recorder()
        rep = run(step_fn, state, batch_fn, cfg, on_step=on_step)
        assert rep.restarts == 1
        assert rep.restored_steps == [2]
        # steps 3, 4 replayed after restoring step 2, identically
        assert rep.steps_run == 12
        assert losses[3][0] == losses[3][1] and losses[4][0] == losses[4][1]

    def test_exceeding_max_restarts_raises(self, tmp_path):
        state, step_fn, batch_fn = _setup()
        cfg = DriverConfig(total_steps=6, ckpt_every=100,
                           ckpt_dir=str(tmp_path), fail_at_steps=(1,),
                           max_restarts=0, async_ckpt=False)
        with pytest.raises(SimulatedFailure):
            run(step_fn, state, batch_fn, cfg)

    def test_resume_from_existing_checkpoint_dir(self, tmp_path):
        state, step_fn, batch_fn = _setup()
        d = str(tmp_path)
        run(step_fn, state, batch_fn, DriverConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=d, async_ckpt=False))
        rep = run(step_fn, state, batch_fn, DriverConfig(
            total_steps=8, ckpt_every=2, ckpt_dir=d, async_ckpt=False))
        assert rep.restored_steps == [3]
        assert rep.steps_run == 4          # only steps 4..7

    def test_async_checkpoints_replay_exactly(self, tmp_path):
        """The default async writer: a failure joins the outstanding write
        before it restores."""
        state, step_fn, batch_fn = _setup()
        losses, on_step = _recorder()
        rep = run(step_fn, state, batch_fn, DriverConfig(
            total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path),
            fail_at_steps=(4,)), on_step=on_step)
        assert rep.restored_steps == [3] and rep.steps_run == 6
        assert all(len(v) == 1 for v in losses.values())

    def test_r9_failure_before_first_checkpoint(self, tmp_path):
        """R9: fail at step 2 with no checkpoint yet.  The port restarts from
        the initial state, so its replayed steps 0 and 1 equal the first
        pass; the reference's replay starts from the state after step 1,
        and its replayed step 0 differs."""
        state, step_fn, batch_fn = _setup()
        losses, on_step = _recorder()
        rep = run(step_fn, state, batch_fn, DriverConfig(
            total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "port"),
            fail_at_steps=(2,), async_ckpt=False), on_step=on_step)
        assert rep.restarts == 1 and rep.restored_steps == []
        assert losses[0][0] == losses[0][1] and losses[1][0] == losses[1][1]

        ref_cfg = ref_get("smollm-360m").reduced()
        ref_model = ref_build(ref_cfg)
        opt = RefAdamW(learning_rate=ref_constant(3e-3))
        src = RefSyntheticLM(ref_cfg, RefShape("t", 16, 8, "train"))
        ref_losses, ref_on_step = _recorder()
        ref_run(jax.jit(ref_make_train_step(ref_model, opt, CTX)),
                ref_init_state(ref_model, jax.random.PRNGKey(0), opt),
                lambda s: src.place(src.batch_for_step(s), CTX),
                RefDriverConfig(total_steps=3, ckpt_every=100,
                                ckpt_dir=str(tmp_path / "ref"),
                                fail_at_steps=(2,), async_ckpt=False),
                on_step=ref_on_step)
        assert len(ref_losses[0]) == 2
        assert ref_losses[0][1] < ref_losses[0][0]      # trained already


class TestStragglerMonitor:
    def test_flags_slow_steps_and_remaps(self):
        remaps = []
        mon = StragglerMonitor(threshold=2.0, evict_after=2,
                               on_remap=remaps.append)
        for s in range(10):
            mon.observe(s, 0.1)
        assert not mon.events
        assert mon.observe(10, 0.5)
        assert mon.observe(11, 0.5)
        assert remaps == [11]
        # recovery resets the consecutive counter
        mon.observe(12, 0.1)
        assert mon.consecutive == 0

    def test_baseline_not_polluted_by_stragglers(self):
        mon = StragglerMonitor(threshold=2.0)
        for s in range(20):
            mon.observe(s, 0.1)
        mon.observe(20, 10.0)
        assert mon.ewma == pytest.approx(0.1, rel=1e-6)

    def test_timed_observes_each_call(self):
        mon = StragglerMonitor()
        step = mon.timed(lambda x: x + 1)
        assert step(0, 1) == 2 and step(1, 2) == 3
        assert mon.ewma is not None and not mon.events
