"""The port's fault-tolerant trainer: the twins of ``tests/test_trainer.py``
(injected failures, bit-exact recovery, straggler watchdog, restart from
the latest checkpoint, an end-to-end small-LM descent through a fault), on
tensors, on the CPU."""
import tempfile
import time

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _toy_step(state, batch):
    w = state["w"]
    target = torch.as_tensor(batch["tokens"], dtype=torch.float32).mean() / 100.0
    g = 2 * (w - target)
    return {"w": w - 0.1 * g}, {"loss": (w - target) ** 2}


def _toy_data():
    return SyntheticTokens(DataConfig(vocab_size=100, seq_len=8, global_batch=4, seed=0))


def _w(x):
    return torch.tensor(x, dtype=torch.float32)


def test_recovery_is_bit_exact_with_failure_free_run():
    data = _toy_data()
    fired = set()

    def fault(step):
        if step in (23, 57) and step not in fired:
            fired.add(step)
            raise RuntimeError("injected")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_save=False)
        tr = Trainer(_toy_step, {"w": _w(5.0)}, data.batch,
                     TrainerConfig(total_steps=80, checkpoint_every=10, log_every=100),
                     checkpoint=mgr, fault_hook=fault)
        rep = tr.run()
        assert rep.restarts == 2
        cur = {"w": _w(5.0)}
        for s in range(80):
            cur, _ = _toy_step(cur, data.batch(s))
        assert torch.equal(cur["w"], tr.state["w"])


def test_failure_before_first_checkpoint_raises():
    data = _toy_data()

    def always_fail(step):
        raise RuntimeError("dead node")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        tr = Trainer(_toy_step, {"w": _w(1.0)}, data.batch,
                     TrainerConfig(total_steps=10, checkpoint_every=5),
                     checkpoint=mgr, fault_hook=always_fail)
        with pytest.raises(RuntimeError, match="before any checkpoint"):
            tr.run()


def test_no_checkpoint_store_surfaces_the_error():
    tr = Trainer(_toy_step, {"w": _w(1.0)}, _toy_data().batch,
                 TrainerConfig(total_steps=5),
                 fault_hook=lambda s: (_ for _ in ()).throw(ValueError("real bug")))
    with pytest.raises(ValueError, match="real bug"):
        tr.run()


def test_max_restarts_enforced():
    data = _toy_data()

    def flaky(step):
        if step == 7:
            raise RuntimeError("permanently broken step")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        tr = Trainer(_toy_step, {"w": _w(1.0)}, data.batch,
                     TrainerConfig(total_steps=20, checkpoint_every=5, max_restarts=3),
                     checkpoint=mgr, fault_hook=flaky)
        with pytest.raises(RuntimeError, match="max_restarts"):
            tr.run()


def test_straggler_watchdog_fires():
    data = _toy_data()
    seen = []

    def slow_batch(step):
        if step == 30:
            time.sleep(0.25)
        return data.batch(step)

    tr = Trainer(_toy_step, {"w": _w(1.0)}, slow_batch,
                 TrainerConfig(total_steps=50, straggler_factor=3.0),
                 on_straggler=lambda s, ratio: seen.append((s, ratio)))
    rep = tr.run()
    assert 30 in rep.stragglers
    assert any(s == 30 for s, _ in seen)


def test_resume_from_latest_checkpoint_on_new_trainer():
    data = _toy_data()
    with tempfile.TemporaryDirectory() as d:
        tr1 = Trainer(_toy_step, {"w": _w(5.0)}, data.batch,
                      TrainerConfig(total_steps=30, checkpoint_every=10),
                      checkpoint=CheckpointManager(d, keep=3, async_save=False))
        tr1.run()
        # "process restart": fresh trainer, same dir -> resumes at 30
        tr2 = Trainer(_toy_step, {"w": _w(5.0)}, data.batch,
                      TrainerConfig(total_steps=60, checkpoint_every=10),
                      checkpoint=CheckpointManager(d, keep=3, async_save=False))
        rep2 = tr2.run()
        assert rep2.steps_run == 30  # only the remaining steps
        cur = {"w": _w(5.0)}
        for s in range(60):
            cur, _ = _toy_step(cur, data.batch(s))
        assert torch.equal(cur["w"], tr2.state["w"])


def test_small_lm_loss_descends_through_faults():
    """End-to-end: the real model, the real (in-place) train step with B3's
    backward on the CPU path, an injected failure rolled back to the last
    checkpoint; the loss still descends."""
    cfg = get_config("gemma-2b", smoke=True)
    tcfg = TrainStepConfig(microbatches=1, remat=False, adamw=AdamWConfig(lr=3e-3),
                           warmup_steps=5, total_steps=40)
    state = init_train_state(cfg, 0, tcfg.adamw, device="cpu")
    step = make_train_step(cfg, tcfg)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=8, kind="bigram"))
    fired = []

    def fault(s):
        if s == 25 and not fired:
            fired.append(s)
            raise RuntimeError("injected")

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step, state, data.batch,
                     TrainerConfig(total_steps=40, checkpoint_every=10, log_every=5),
                     checkpoint=CheckpointManager(d, keep=2, async_save=False),
                     fault_hook=fault)
        rep = tr.run()
    assert rep.restarts == 1
    losses = [r["loss"] for r in rep.history if "loss" in r]
    assert losses[-1] < losses[0] - 0.3, losses
