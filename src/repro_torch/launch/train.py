"""Training CLI: ``python -m repro_torch.launch.train --arch gemma-2b [--smoke]``.

Wires the stack: config -> synthetic data pipeline -> train step (loss,
gradient through the backward kernels, AdamW) -> fault-tolerant Trainer
(checkpoint/restart, straggler watchdog), on the card (``--device cpu``
for the CPU).  Without ``--smoke`` the model is the published config at
full width (gemma-2b: 2.5 B parameters, ~45 GB of training state and
activations at ``--batch 4 --seq 512``).

``--arch`` takes every ported config: the dense decoders gemma-2b, yi-9b,
h2o-danube3-4b and command-r-plus-104b (parallel blocks), the MoE archs
granite-moe-1b-a400m and olmoe-1b-7b, falcon-mamba-7b,
recurrentgemma-2b, and the frontend archs llava-next-34b and
whisper-medium.  At full width yi-9b, command-r-plus-104b, olmoe-1b-7b,
falcon-mamba-7b and llava-next-34b need more than one H100's 80 GB with
AdamW; the others fit.  As in the reference's CLI, the frontend archs'
loss graph is captured with their embeddings (``input_specs``), while
the synthetic stream's batches carry tokens only: llava-next-34b then
trains on the text alone, and whisper-medium's first step raises (its
encoder has no ``frames``) before any update.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --device cpu --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

``--pinning auto|on`` sets the process Runtime's executor-thread core
pinning (:mod:`repro_torch.hwperf`), applied when a host run first creates
its pool, as in the reference's CLI.

``--spans PATH`` turns on the train step's recorder
(:mod:`repro_torch.core.trace`: ``train.*``, ``optim.*`` and ``moe.*``
spans, the MoE counters) and writes what it holds to PATH as Chrome-trace
events whose ``ts`` plus ``baseTimeNanoseconds`` / 1000 is ``time.time_ns()``
in µs, as in a ``torch.profiler`` export, so the two lie together in
Perfetto.  A sharded run's ranks record nothing (DTensor state).

``--mesh DxM`` trains sharded over a ``("data", "model")`` mesh of D x M
ranks (``repro_torch.dist``): the state is DTensors placed by
``state_pspecs``, the batch shards over ``data``, and the step runs under
``MeshCtx`` / ``use_mesh``, as the reference's CLI does.  The group comes
from the launcher (``torchrun``) or is a world of one; ``nccl`` on the
card, ``gloo`` with ``--device cpu``.  A mesh whose size differs from the
world's is refused::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma-2b --smoke --device cpu --mesh 2x2 --steps 20 --batch 8 --seq 32
"""
from __future__ import annotations

import argparse
import json

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core import trace
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True,
                   help="a ported config: gemma-2b, yi-9b, h2o-danube3-4b, "
                        "command-r-plus-104b, granite-moe-1b-a400m, olmoe-1b-7b, "
                        "falcon-mamba-7b, recurrentgemma-2b, llava-next-34b, "
                        "whisper-medium")
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
    p.add_argument("--mesh", default=None,
                   help="sharded training over a DxM (data x model) mesh of ranks "
                        "(launch D*M ranks with torchrun --nproc-per-node D*M)")
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
                   help="pin the Runtime's executor threads to disjoint "
                        "core sets (repro_torch.hwperf): 'auto' where affinity "
                        "is supported, 'on' warns once where it is not")
    p.add_argument("--dump-trace", choices=("ascii", "csv"), default=None,
                   help="print the Graphi loss graph's execution timeline "
                        "(simulated on this sim-backend path)")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="record the train step's spans and counters "
                        "(repro_torch.core.trace) and write them to PATH as a "
                        "Chrome trace on torch.profiler's time base")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.runtime import Runtime, set_default_runtime

    dev = resolve_device(args.device)
    rank, mesh = 0, None
    if args.mesh is not None:
        from repro_torch.dist.train import init_group, parse_mesh

        mesh = parse_mesh(args.mesh)
        rank, world = init_group(dev.type)
        if mesh.size != world:
            import torch.distributed as dist

            dist.destroy_process_group()
            raise SystemExit(
                f"--mesh {args.mesh} needs {mesh.size} ranks, the world has {world}: "
                f"launch it with torchrun --nproc-per-node {mesh.size}")
        if dev.type == "cuda":
            dev = resolve_device("cuda")      # this rank's card
    say = print if rank == 0 else (lambda *a, **k: None)
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
        say(f"graphi: loss graph {len(exe.graph)} nodes, width "
              f"{exe.graph.width()}, {exe.schedule.n_executors}x"
              f"{exe.schedule.team_size} executors ({exe.schedule.policy}), "
              f"scheduled makespan "
              f"{scheduled_makespan * 1e3:.2f} ms ({runtime.describe()})")
        if args.dump_trace:
            say(exe.render_trace(fmt=args.dump_trace))

    tcfg = TrainStepConfig(
        microbatches=args.microbatches,
        remat=not args.smoke,
        adamw=AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20),
    )
    state = init_train_state(cfg, 0, tcfg.adamw, device=dev)
    if mesh is None:
        step = make_train_step(cfg, tcfg)
    else:
        from repro_torch.dist.sharding import state_pspecs
        from repro_torch.dist.train import distribute_tree, make_sharded_train_step

        dm = mesh.to_device_mesh(dev.type)
        state = distribute_tree(state, state_pspecs(cfg, state, mesh), mesh, dm)
        step = make_sharded_train_step(cfg, tcfg, mesh, dm, global_batch=args.batch)
        say(f"mesh: {' x '.join(f'{a}={n}' for a, n in mesh.shape.items())}, "
            f"batch over {step.ctx.batch or '()'}")

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
    if args.spans:
        trace.reset()
        trace.enable()
    report = trainer.run()
    runtime.close()
    if args.spans:
        trace.disable()
        snap = trace.snapshot()
        if rank == 0:
            with open(args.spans, "w") as f:
                json.dump(trace.chrome_events(snap), f)
        say(f"spans: {len(snap['spans'])} spans, {len(snap['counters'])} counters "
            f"-> {args.spans}")
    for rec in report.history:
        if "loss" in rec:
            say(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                f"({rec['time_s']*1e3:.0f} ms/step)")
    say(f"done: {report.steps_run} steps, {report.restarts} restarts, "
        f"final loss {report.final_loss:.4f}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
