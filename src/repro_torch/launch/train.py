"""Training CLI: ``python -m repro_torch.launch.train --arch gemma-2b [--smoke]``.

Wires the stack: config -> synthetic data pipeline -> train step (loss,
gradient through the backward kernels, AdamW) -> fault-tolerant Trainer
(checkpoint/restart, straggler watchdog), on the card (``--device cpu``
for the CPU).  Without ``--smoke`` the model is the published config at
full width (gemma-2b: 2.5 B parameters, ~45 GB of training state and
activations at ``--batch 4 --seq 512``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --device cpu --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

Not ported yet, and refused with the ROADMAP item that brings them:
``--mesh`` (sharded training, A15) and ``--pinning`` other than ``off``
(core pinning, A13).
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

_NOT_PORTED = {
    "mesh": "--mesh needs the distribution layer, not ported yet (ROADMAP A15)",
    "pinning": "--pinning needs the hwperf layer, not ported yet (ROADMAP A13)",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model trains (default: the card)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data", default="bigram", choices=("bigram", "uniform", "copy"))
    p.add_argument("--mesh", default=None, help="sharded training (not ported)")
    p.add_argument("--no-graphi", action="store_true",
                   help="skip the Graphi capture/schedule of the loss graph")
    p.add_argument("--calibration-store", default=None,
                   help="JSON path backing the process Runtime's calibration "
                        "store (shared with any serve engine in this process)")
    p.add_argument("--schedule-search", choices=("off", "auto", "force"),
                   default="auto",
                   help="simulator-guided schedule search for the Graphi "
                        "loss-graph schedule: 'auto' searches when measured "
                        "costs back the graph, 'force' always, 'off' plain "
                        "CPF")
    p.add_argument("--pinning", choices=("off", "auto", "on"), default="off",
                   help="executor-thread core pinning (only 'off' is ported)")
    p.add_argument("--dump-trace", choices=("ascii", "csv"), default=None,
                   help="print the Graphi loss graph's execution timeline "
                        "(simulated on this sim-backend path)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    refused = [msg for key, msg in _NOT_PORTED.items()
               if (args.mesh is not None if key == "mesh" else args.pinning != "off")]
    if refused:
        raise SystemExit("; ".join(refused))

    from repro_torch.device import resolve_device
    from repro_torch.runtime import Runtime, set_default_runtime

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    # the process-wide Runtime: the Graphi view of the loss graph compiles
    # through it (shared schedule caches + persistent calibration)
    runtime = Runtime(device=dev, calibration_path=args.calibration_store,
                      pinning=args.pinning)
    set_default_runtime(runtime, dev.type)
    scheduled_makespan = None
    if not args.no_graphi:
        from repro_torch.train.step import compile_lm_loss

        exe = compile_lm_loss(cfg, shape, backend="sim", runtime=runtime, device=dev,
                              schedule_search=args.schedule_search)
        scheduled_makespan = exe.schedule.makespan
        print(f"graphi: loss graph {len(exe.graph)} nodes, width "
              f"{exe.graph.width()}, {exe.schedule.n_executors}x"
              f"{exe.schedule.team_size} executors ({exe.schedule.policy}), "
              f"scheduled makespan "
              f"{scheduled_makespan * 1e3:.2f} ms ({runtime.describe()})")
        if args.dump_trace:
            print(exe.render_trace(fmt=args.dump_trace))

    tcfg = TrainStepConfig(
        microbatches=args.microbatches,
        remat=not args.smoke,
        adamw=AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20),
    )
    state = init_train_state(cfg, 0, tcfg.adamw, device=dev)
    step = make_train_step(cfg, tcfg)

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, kind=args.data,
    ))

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    trainer = Trainer(
        step, state, data.batch,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=args.ckpt_every,
            log_every=args.log_every,
        ),
        checkpoint=ckpt,
        scheduled_makespan=scheduled_makespan,
    )
    report = trainer.run()
    runtime.close()
    for rec in report.history:
        if "loss" in rec:
            print(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                  f"({rec['time_s']*1e3:.0f} ms/step)")
    print(f"done: {report.steps_run} steps, {report.restarts} restarts, "
          f"final loss {report.final_loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
