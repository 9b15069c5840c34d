#!/usr/bin/env python3
"""Serving bench of the PyTorch port: wave batcher vs per-slot continuous
batching on one Poisson workload (BENCH_serve_torch.json); the twin of
``scripts/bench_serve.py``.

One workload, two engines.  Staggered Poisson arrivals with mixed prompt
lengths: the regime the wave batcher handles worst (length bucketing and
whole-wave stalls) and the continuous engine is built for (slot admission
between decode steps).  Each engine first runs the workload once
unmeasured (the continuous engine's capture and first runs; the wave
engine runs eagerly and has nothing to compile), then the timed pass
records tokens/s and per-request latency (completion - arrival).

    python3 scripts/torch_bench_serve.py [--device cpu] [--out FILE]
    python3 scripts/torch_bench_serve.py --arch h2o-danube3-4b --full

By default the smoke gemma-2b with a 300-token vocabulary (its padded
head has sampleable columns the serve path must mask), as the original
runs; ``--arch NAME --full`` runs any ported config at full width.  The
JSON is written before the gates run.

Gates (the original's):
  * every emitted token id is < cfg.vocab_size (pad-vocab mask);
  * per-request greedy parity: continuous outputs equal wave outputs;
  * continuous beats wave on p95 per-request latency (speed);
  * continuous tokens/s is no worse than 0.9x wave (speed).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def gate(cond, msg):
    """Acceptance gate that survives ``python -O`` (no bare asserts)."""
    if not cond:
        raise SystemExit(f"GATE FAILED: {msg}")


def card(dev) -> dict:
    """The device the numbers were taken on; for the card, its name and
    ``nvidia-smi``'s name and power limit (a card may be set below 700 W)."""
    import subprocess

    import torch

    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "name_power_limit": smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else None}


def reset(workload):
    from repro_torch.serve.engine import Request

    return [(t, Request(request_id=r.request_id, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens, eos_id=r.eos_id))
            for t, r in workload]


def build_model(arch: str, full: bool, device, **smoke):
    """The config (full width, or the smoke config with ``smoke``
    overrides) and random weights from seed 0 on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch, smoke=not full)
    if not full and smoke:
        cfg = cfg.reduced(**smoke)
    return cfg, transformer.init_params(cfg, 0, device=device)


def run_engine(make_engine, workload, *, continuous, warm=None):
    """One unmeasured pass, then the timed one: (row, completed requests)."""
    from repro_torch.launch.serve import drive, percentile

    eng = make_engine()
    if warm is not None:
        warm(eng)
    drive(eng, reset(workload), continuous=continuous)
    if continuous:
        # the artifact's loop counters must describe the timed pass only
        eng.n_steps = eng.n_decode_steps = eng.n_overlapped_prefills = 0
    done, lat, wall = drive(eng, reset(workload), continuous=continuous)
    n_tokens = sum(len(r.output) for r in done)
    row = {
        "n_requests": len(done),
        "n_tokens": n_tokens,
        "wall_s": round(wall, 4),
        "tok_per_s": round(n_tokens / wall, 2),
        "lat_p50_ms": round(percentile(list(lat.values()), 0.50) * 1e3, 2),
        "lat_p95_ms": round(percentile(list(lat.values()), 0.95) * 1e3, 2),
        "max_token_id": max(t for r in done for t in r.output),
    }
    if continuous:
        row.update({
            "n_steps": eng.n_steps,
            "n_decode_steps": eng.n_decode_steps,
            "n_overlapped_prefills": eng.n_overlapped_prefills,
            "n_executors": eng.n_executors,
            "runtime_workers": eng.runtime.n_workers if eng.runtime else None,
            "profiled_config": list(eng.profile.best_config),
        })
        eng.close()
    return row, done


def run(args) -> tuple[dict, dict]:
    """Both engines over one workload: (payload, {engine: done requests})."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import build_requests
    from repro_torch.runtime import Runtime, set_default_runtime
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig, ServeEngine

    dev = resolve_device(args.device)
    cfg, params = build_model(args.arch, args.full, dev, vocab_size=300)
    if not args.full and not cfg.padded_vocab > cfg.vocab_size:
        raise SystemExit("the smoke workload needs a padded vocabulary")
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    scfg = ServeConfig(max_batch=args.max_batch, max_len=max(prompt_lens) + args.max_new + 1)
    workload = build_requests(cfg, n_requests=args.requests, prompt_lens=prompt_lens,
                              max_new=args.max_new, arrival_rate=args.arrival_rate)
    # the continuous engine leases executors per step from one process
    # Runtime (the production wiring) instead of constructing its own pool
    runtime = Runtime(device=dev)
    prev = set_default_runtime(runtime, dev.type)
    t0 = time.time()
    try:
        wave_row, wave_done = run_engine(lambda: ServeEngine(cfg, params, scfg, device=dev),
                                         workload, continuous=False)
        cont_row, cont_done = run_engine(
            lambda: ContinuousEngine(cfg, params, scfg, device=dev, runtime=runtime),
            workload, continuous=True, warm=lambda e: e.warmup(prompt_lens))
    finally:
        set_default_runtime(prev, dev.type)
        runtime.close()
    wave_row["bench"] = "serve_wave"
    cont_row["bench"] = "serve_continuous"
    payload = {
        "total_wall_s": round(time.time() - t0, 2),
        "device": card(dev),
        "workload": {
            "arch": cfg.name, "full": args.full, "dtype": str(cfg.dtype).split(".")[-1],
            "vocab_size": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
            "requests": args.requests, "prompt_lens": prompt_lens, "max_new": args.max_new,
            "arrival_rate": args.arrival_rate, "max_batch": args.max_batch,
        },
        "rows": [wave_row, cont_row],
    }
    return payload, {"wave": wave_done, "continuous": cont_done}


def gates(payload: dict, done: dict) -> list[tuple[str, bool, str]]:
    """(kind, holds, message) of every gate; kind ``"parity"`` or
    ``"speed"`` (the speed thresholds were set on a CPU host)."""
    vocab = payload["workload"]["vocab_size"]
    wave, cont = (next(r for r in payload["rows"] if r["bench"] == b)
                  for b in ("serve_wave", "serve_continuous"))
    out = []
    for name, reqs in done.items():
        bad = [t for r in reqs for t in r.output if t >= vocab]
        out.append(("parity", not bad, f"{name} emitted out-of-vocab ids: {bad[:5]}"))
    wave_out = {r.request_id: r.output for r in done["wave"]}
    out.append(("parity", all(r.output == wave_out[r.request_id] for r in done["continuous"]),
                "continuous outputs diverge from wave outputs"))
    out.append(("speed", cont["lat_p95_ms"] < wave["lat_p95_ms"],
                f"continuous p95 {cont['lat_p95_ms']}ms >= wave {wave['lat_p95_ms']}ms"))
    out.append(("speed", cont["tok_per_s"] >= 0.9 * wave["tok_per_s"],
                f"continuous {cont['tok_per_s']} tok/s < 0.9x wave {wave['tok_per_s']}"))
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="BENCH_serve_torch.json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--full", action="store_true",
                   help="the arch's published config, not its smoke config")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--prompt-lens", default="4,12,20,28")
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--arrival-rate", type=float, default=40.0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    payload, done = run(args)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    for r in payload["rows"]:
        print(f"{r['bench']:18s} tok/s={r['tok_per_s']:8.1f} "
              f"p50={r['lat_p50_ms']:7.1f}ms p95={r['lat_p95_ms']:7.1f}ms "
              f"wall={r['wall_s']:.2f}s")
    print(f"wrote {args.out} ({payload['total_wall_s']}s) on {payload['device']}")
    for _, holds, msg in gates(payload, done):
        gate(holds, msg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
