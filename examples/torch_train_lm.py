"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM on the
synthetic bigram stream with the full stack — train step with the backward
kernels, microbatching, remat, checkpointing, fault-tolerant trainer,
straggler watchdog — on the card (``--device cpu`` for the CPU).  The twin
of ``examples/train_lm.py``.

``--tiny`` drops to a ~4M model.  ``--arch`` trains a registry config
instead (any family the port trains: dense, MoE, Mamba, Griffin; its smoke
size with ``--tiny``).  The loss must descend from ~ln(V) toward the
bigram entropy floor — that descent is the acceptance check printed at the
end.

    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu --arch falcon-mamba-7b
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200    # ~100M params, card
"""
import argparse
import math
import os
import tempfile


from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeSpec, get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    TrainStepConfig,
    compile_lm_loss,
    init_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=5, d_ff=2560, vocab_size=32_000,
        act="silu", scan_layers=True,
    )


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="lm-tiny", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2_048,
        act="silu", scan_layers=True,
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--arch", default=None,
                   help="a registry config (e.g. granite-moe-1b-a400m) instead of the "
                        "built-in dense LM; --tiny takes its smoke size")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: a new one under the temp dir)")
    args = p.parse_args()
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.mkdtemp(), "train_lm_ckpt")

    if args.arch:
        cfg = get_config(args.arch, smoke=args.tiny)
    else:
        cfg = model_tiny() if args.tiny else model_100m()
    n_params = cfg.n_params()
    print(f"model: {cfg.name}, {n_params/1e6:.1f}M params")

    tcfg = TrainStepConfig(
        microbatches=2, remat=True,
        adamw=AdamWConfig(lr=1e-3),
        warmup_steps=max(1, args.steps // 10), total_steps=args.steps,
    )
    state = init_train_state(cfg, 0, tcfg.adamw, device=args.device)
    step = make_train_step(cfg, tcfg)

    # Graphi view of the same loss through the process Runtime: capture ->
    # profile -> CPF schedule gives the modelled per-step makespan the
    # trainer reports next to wall-clock (one session also means one
    # executor pool / calibration store if a serve engine shares the process)
    from repro_torch.runtime import default_runtime
    runtime = default_runtime(args.device)
    shape = ShapeSpec("train_lm", args.seq, args.batch, "train")
    exe = compile_lm_loss(cfg, shape, backend="sim", runtime=runtime, device=args.device)
    ms = exe.schedule.makespan
    print(f"graphi: loss graph {len(exe.graph)} nodes, width {exe.graph.width()}, "
          f"{exe.schedule.n_executors}x{exe.schedule.team_size} executors, "
          f"scheduled makespan {ms*1e3:.2f} ms (model: {exe.hw.name})")

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        kind="bigram", bigram_noise=0.15,
    ))
    trainer = Trainer(
        step, state, data.batch,
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=max(20, args.steps // 4),
                      log_every=max(5, args.steps // 20)),
        checkpoint=CheckpointManager(ckpt_dir, keep=2),
        scheduled_makespan=ms,
    )
    report = trainer.run()

    first = next(r["loss"] for r in report.history if "loss" in r)
    last = report.final_loss
    # bigram with noise eps over vocab V: H = (1-eps)ln(1/(1-eps)) ~ floor
    print("\nstep      loss    ms/step")
    for r in report.history:
        if "loss" in r:
            print(f"{r['step']:5d}  {r['loss']:8.4f}  {r['time_s']*1e3:8.0f}")
    print(f"\nuniform baseline ln(V) = {math.log(cfg.vocab_size):.3f}")
    print(f"loss {first:.3f} -> {last:.3f}  "
          f"({'DESCENDED OK' if last < first - 0.5 else 'NO DESCENT — check setup'})")
    print(f"restarts={report.restarts} stragglers={len(report.stragglers)}")


if __name__ == "__main__":
    main()
