"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog,
failure injection — the JAX package's ``train/trainer.py`` on tensors.

The loop's recovery contract (tested in tests/test_trainer.py):

* any exception inside a step (injected or real — a down-node manifests as a
  failed collective) rolls the loop back to the last published checkpoint;
  the data pipeline is stateless-by-step, so the replayed token stream is
  byte-identical to the no-failure run;
* checkpoints are atomic (see checkpoint/store.py), so a crash *during* a
  save can't corrupt the restore point;
* restore puts each leaf on its template leaf's device, or, for a sharded
  state (DTensor leaves), onto its template leaf's mesh and placements:
  checkpoints hold full tensors, so a step saved on one mesh resumes on
  another (the elastic re-mesh, ``checkpoint.restore_state``).

A step counts as done when its new state is on the device: the loop
synchronises the device of the state's first tensor (the reference's
``jax.block_until_ready``), so a fault raised by the card lands in the step
that caused it and the timer covers the device work.

The straggler watchdog EWMAs the step wall-time; a step slower than
``straggler_factor`` x EWMA is recorded and reported to ``on_straggler``
(at pod scale: the hook re-balances microbatch counts or evicts the slow
host; on this box the tests assert detection fires).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import CheckpointManager

__all__ = ["TrainerConfig", "Trainer", "TrainReport"]


def _block_until_ready(state: Any) -> Any:
    for leaf in pytree.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            break
    return state


@dataclass(frozen=True)
class TrainerConfig:
    total_steps: int
    checkpoint_every: int = 50
    log_every: int = 10
    max_restarts: int = 8
    straggler_alpha: float = 0.3      # EWMA smoothing
    straggler_factor: float = 2.5     # threshold multiple
    straggler_warmup: int = 3         # steps before the watchdog arms


@dataclass
class TrainReport:
    history: list[dict] = field(default_factory=list)
    restarts: int = 0
    stragglers: list[int] = field(default_factory=list)
    steps_run: int = 0

    @property
    def final_loss(self) -> float | None:
        for rec in reversed(self.history):
            if "loss" in rec:
                return rec["loss"]
        return None


class Trainer:
    def __init__(
        self,
        step_fn: Callable[[Any, Any], tuple[Any, dict]],
        state: Any,
        batch_for_step: Callable[[int], Any],
        cfg: TrainerConfig,
        *,
        checkpoint: CheckpointManager | None = None,
        fault_hook: Callable[[int], None] | None = None,
        on_straggler: Callable[[int, float], None] | None = None,
        scheduled_makespan: float | None = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batch_for_step = batch_for_step
        self.cfg = cfg
        self.ckpt = checkpoint
        self.fault_hook = fault_hook
        self.on_straggler = on_straggler
        # Graphi-modelled makespan of the captured loss graph (see
        # train/step.py::compile_lm_loss) — reported next to wall-clock so
        # logs show how far the real step sits from the scheduled bound
        self.scheduled_makespan = scheduled_makespan
        # structure snapshot: restore reads each leaf's device and dtype
        self._template = pytree.tree_map(lambda x: x, state)

    # -- recovery ------------------------------------------------------------
    def _restore(self) -> int:
        """Roll back to the latest checkpoint; returns the step to resume at."""
        if self.ckpt is None:
            raise RuntimeError("recovery needs a checkpoint store")
        self.ckpt.wait()
        latest = self.ckpt.latest()
        if latest is None:
            raise RuntimeError("step failed before any checkpoint existed")
        _, self.state = self.ckpt.restore(self._template, step=latest)
        return latest

    # -- main loop -----------------------------------------------------------
    def run(self, start_step: int | None = None) -> TrainReport:
        cfg = self.cfg
        report = TrainReport()

        step = start_step if start_step is not None else 0
        if start_step is None and self.ckpt is not None:
            latest = self.ckpt.latest()
            if latest is not None:
                _, self.state = self.ckpt.restore(self._template, step=latest)
                step = latest

        ewma: float | None = None
        while step < cfg.total_steps:
            # the timer covers batch fetch too: a slow host stalls its input
            # pipeline as often as its compute, and both must trip the watchdog.
            # Fetch errors are NOT node faults, though — a deterministic data
            # bug must surface immediately, not burn max_restarts replays.
            t0 = time.perf_counter()
            batch = self.batch_for_step(step)
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                new_state, metrics = self.step_fn(self.state, batch)
                new_state = _block_until_ready(new_state)
            except Exception as e:  # noqa: BLE001 — any failure = node fault
                if self.ckpt is None:
                    raise  # no recovery point: surface the real error
                report.restarts += 1
                if report.restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={cfg.max_restarts}"
                    ) from e
                step = self._restore()
                report.history.append({"step": step, "event": "restart",
                                       "error": type(e).__name__})
                continue
            self.state = new_state
            dt = time.perf_counter() - t0

            # straggler watchdog
            if ewma is not None and report.steps_run >= cfg.straggler_warmup:
                if dt > cfg.straggler_factor * ewma:
                    report.stragglers.append(step)
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt / ewma)
            ewma = dt if ewma is None else (
                cfg.straggler_alpha * dt + (1 - cfg.straggler_alpha) * ewma
            )

            report.steps_run += 1
            step += 1
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                rec = {"step": step, "time_s": dt}
                if self.scheduled_makespan is not None:
                    rec["graphi_makespan_s"] = self.scheduled_makespan
                for k, v in metrics.items():
                    try:
                        rec[k] = float(v)
                    except (TypeError, ValueError):
                        pass
                report.history.append(rec)
            if self.ckpt is not None and step % cfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return report
