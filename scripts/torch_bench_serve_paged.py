#!/usr/bin/env python3
"""Paged-KV serving bench of the PyTorch port: paged engine vs per-slot
continuous batching (BENCH_serve_paged_torch.json); the twin of
``scripts/bench_serve_paged.py``.

Two workloads, one model, both engines leasing executors from one Runtime.

Workload A (throughput + memory): every prompt is a shared page-aligned
system prefix plus a short unique tail, arriving Poisson: the regime
prefix sharing is built for.  The per-slot engine re-prefills the system
prompt for every request; the paged engine maps the already-computed pages
and prefills only the tail.  Paged and per-slot timed legs are interleaved
(P, C, P, C, ...) so drift of the machine cancels; the gate compares median
legs.

Workload B (admission): short prompts with and without one long prompt
(>= 8x the median short) in flight.  Chunked prefill must keep
admission-to-first-token bounded by the chunk size, not by the stranger's
prompt length.

    python3 scripts/torch_bench_serve_paged.py [--device cpu] [--out FILE]
    python3 scripts/torch_bench_serve_paged.py --arch h2o-danube3-4b --full

By default the original's model: the smoke gemma-2b widened to d_model 256
(8 / 2 heads, d_ff 1024) with a 300-token vocabulary, so that a prefill
costs real compute beside a decode step; ``--arch NAME --full`` runs any
ported attention-only config at full width.
The JSON is written before the gates run.

Gates (the original's):
  * paged token streams match the per-slot engine's bit-exactly, and
    prefix sharing engaged;
  * paged tokens/s >= 1.3x per-slot on the shared-prefix workload (speed);
  * paged peak hot KV bytes <= 0.6x the per-slot engine's resident cache;
  * short-prompt p95 admission-to-first-token with the long prompt in
    flight <= 2x the short-only p95 (speed).
"""
import argparse
import json
import statistics
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


def build_shared_prefix_requests(cfg, *, n_requests, system, tail_lens, max_new,
                                 arrival_rate, seed=0):
    """Poisson arrivals, every prompt = shared system prefix + unique tail."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        tail = rng.integers(1, cfg.vocab_size,
                            size=tail_lens[i % len(tail_lens)]).astype(np.int32)
        out.append((t, Request(request_id=i, prompt=np.concatenate([system, tail]),
                               max_new_tokens=max_new)))
    return out


def drive_first_token(engine, arrivals):
    """Like ``launch.serve.drive`` but stamps each request's *first* emitted
    token; returns (done, {request_id: admission_to_first_token_seconds})."""
    t0 = time.perf_counter()
    todo = list(arrivals)
    submit_t, first_t = {}, {}
    while True:
        now = time.perf_counter() - t0
        while todo and todo[0][0] <= now:
            r = todo.pop(0)[1]
            engine.submit(r)
            submit_t[r.request_id] = time.perf_counter() - t0
        if engine.has_work:
            engine.step()
            stamp = time.perf_counter() - t0
            live = engine.completed + [s for s in engine.slots if s is not None]
            for r in live:
                if r.output and r.request_id not in first_t:
                    first_t[r.request_id] = stamp
        elif todo:
            time.sleep(max(0.0, todo[0][0] - (time.perf_counter() - t0)))
        else:
            break
    done = engine.run()
    return done, {i: first_t[i] - submit_t[i] for i in first_t}


def timed_leg(engine, workload):
    from repro_torch.launch.serve import drive, percentile

    done, lat, wall = drive(engine, reset(workload), continuous=True)
    n_tokens = sum(len(r.output) for r in done)
    return done, {
        "n_tokens": n_tokens,
        "wall_s": round(wall, 4),
        "tok_per_s": round(n_tokens / wall, 2),
        "lat_p95_ms": round(percentile(list(lat.values()), 0.95) * 1e3, 2),
    }


def build_model(args, device):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    if args.full:
        cfg = get_config(args.arch)
    else:
        # wider than the default smoke config: prefill must cost real compute
        # relative to a decode step, or prefix sharing has nothing to save
        cfg = get_config(args.arch, smoke=True).reduced(
            vocab_size=300, d_model=args.d_model, n_heads=8, n_kv_heads=2,
            d_ff=4 * args.d_model)
    return cfg, transformer.init_params(cfg, 0, device=device)


def run(args) -> tuple[dict, dict]:
    """Both workloads: (payload, {"paged" / "per_slot": done requests of
    the last workload-A leg})."""
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import drive, percentile
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime, set_default_runtime
    from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
    from repro_torch.serve.paged import PagedConfig, PagedEngine

    dev = resolve_device(args.device)
    cfg, params = build_model(args, dev)
    rng = np.random.default_rng(7)
    system = rng.integers(1, cfg.vocab_size, size=args.system_len).astype(np.int32)
    tail_lens = [4, 8, 12, 16]
    scfg = ServeConfig(max_batch=args.max_batch,
                       max_len=args.system_len + max(tail_lens) + 2 * args.max_new)
    workload = build_shared_prefix_requests(
        cfg, n_requests=args.requests, system=system, tail_lens=tail_lens,
        max_new=args.max_new, arrival_rate=args.arrival_rate)

    runtime = Runtime(device=dev)
    prev = set_default_runtime(runtime, dev.type)
    t0 = time.time()
    try:
        paged = PagedEngine(cfg, params, scfg, runtime=runtime, device=dev,
                            paged=PagedConfig(page_size=args.page_size,
                                              prefill_chunk=args.prefill_chunk))
        cont = ContinuousEngine(cfg, params, scfg, runtime=runtime, device=dev)
        cont.warmup([len(r.prompt) for _, r in workload])
        # one unmeasured pass each (captures; seeds the prefix registry with
        # the system prompt's pages: the steady state under measurement)
        drive(paged, reset(workload), continuous=True)
        drive(cont, reset(workload), continuous=True)
        # the cold-start pass prefills the system prompt in every slot at
        # once; the peak under measurement is the steady state with a warm
        # prefix cache
        paged.page_pool.peak_used = paged.page_pool.hot()

        # workload A: interleaved timed legs
        paged_legs, cont_legs = [], []
        paged_done = cont_done = None
        for _ in range(args.legs):
            paged_done, row = timed_leg(paged, workload)
            paged_legs.append(row)
            cont_done, row = timed_leg(cont, workload)
            cont_legs.append(row)
        paged_tps = statistics.median(r["tok_per_s"] for r in paged_legs)
        cont_tps = statistics.median(r["tok_per_s"] for r in cont_legs)
        # per-slot KV is resident for every slot at full width the whole
        # time; paged peak counts hot pages only (a cold prefix is reclaimable)
        cache_len = transformer._attn_cache_len(cfg, scfg.max_len)
        per_slot_kv_bytes = int(args.max_batch * cache_len * paged.page_bytes
                                // args.page_size)
        paged_kv_bytes = paged.stats()["peak_kv_bytes"]

        # workload B: admission-to-first-token under a long prefill
        shorts = build_shared_prefix_requests(
            cfg, n_requests=12, system=np.empty(0, np.int32), tail_lens=[8],
            max_new=args.max_new, arrival_rate=30.0, seed=11)
        long_prompt = rng.integers(1, cfg.vocab_size, size=8 * 8 + 8).astype(np.int32)
        for _, r in shorts:
            r.request_id += 100
        _, base_ft = drive_first_token(paged, reset(shorts))
        with_long = [(0.0, Request(request_id=99, prompt=long_prompt,
                                   max_new_tokens=args.max_new))] + reset(shorts)
        _, long_ft = drive_first_token(paged, with_long)
        base_p95 = percentile(list(base_ft.values()), 0.95)
        mixed_p95 = percentile([v for i, v in long_ft.items() if i != 99], 0.95)
        stats = paged.stats()
        n_exec = cont.n_executors
        paged.close()
        cont.close()
    finally:
        set_default_runtime(prev, dev.type)
        runtime.close()
    payload = {
        "total_wall_s": round(time.time() - t0, 2),
        "device": card(dev),
        "workload": {
            "arch": cfg.name, "full": args.full, "layers": cfg.n_layers,
            "dtype": str(cfg.dtype).split(".")[-1], "vocab_size": cfg.vocab_size,
            "requests": args.requests, "system_len": args.system_len,
            "tail_lens": tail_lens, "max_new": args.max_new,
            "arrival_rate": args.arrival_rate, "max_batch": args.max_batch,
            "page_size": args.page_size, "prefill_chunk": paged.chunk,
            "n_pages": paged.page_pool.n_pages, "legs": args.legs,
        },
        "rows": [
            {"bench": "serve_paged", "tok_per_s": paged_tps,
             "legs": paged_legs, **stats, "peak_kv_bytes": paged_kv_bytes},
            {"bench": "serve_per_slot", "tok_per_s": cont_tps,
             "legs": cont_legs, "peak_kv_bytes": per_slot_kv_bytes, "n_executors": n_exec},
        ],
        "admission": {
            "short_only_p95_ms": round(base_p95 * 1e3, 2),
            "with_long_p95_ms": round(mixed_p95 * 1e3, 2),
            "long_prompt_len": len(long_prompt),
        },
    }
    return payload, {"paged": paged_done, "per_slot": cont_done}


def gates(payload: dict, done: dict) -> list[tuple[str, bool, str]]:
    """(kind, holds, message) of every gate; kind ``"parity"``,
    ``"memory"`` or ``"speed"`` (the speed thresholds were set on a CPU
    host)."""
    paged, cont = payload["rows"]
    adm = payload["admission"]
    cont_out = {r.request_id: r.output for r in done["per_slot"]}
    return [
        ("parity", all(r.output == cont_out[r.request_id] for r in done["paged"]),
         "paged outputs diverge from per-slot outputs"),
        ("parity", paged["n_shared_pages"] > 0, "prefix sharing never engaged"),
        ("speed", paged["tok_per_s"] >= 1.3 * cont["tok_per_s"],
         f"paged {paged['tok_per_s']} tok/s < 1.3x per-slot {cont['tok_per_s']}"),
        ("memory", paged["peak_kv_bytes"] <= 0.6 * cont["peak_kv_bytes"],
         f"paged peak KV {paged['peak_kv_bytes']}B > 0.6x per-slot {cont['peak_kv_bytes']}B"),
        ("speed", adm["with_long_p95_ms"] <= 2.0 * adm["short_only_p95_ms"],
         f"admission p95 with long prefill {adm['with_long_p95_ms']}ms > 2x short-only "
         f"{adm['short_only_p95_ms']}ms"),
    ]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="BENCH_serve_paged_torch.json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--full", action="store_true",
                   help="the arch's published config, not its widened smoke config")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--max-new", type=int, default=6)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--legs", type=int, default=3)
    p.add_argument("--system-len", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--arrival-rate", type=float, default=40.0)
    p.add_argument("--d-model", type=int, default=256)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    payload, done = run(args)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    for r in payload["rows"]:
        print(f"{r['bench']:14s} tok/s={r['tok_per_s']:8.1f} peak_kv={r['peak_kv_bytes']:>9d}B")
    adm = payload["admission"]
    print(f"admission p95: short-only={adm['short_only_p95_ms']:.1f}ms "
          f"with-long={adm['with_long_p95_ms']:.1f}ms")
    print(f"wrote {args.out} ({payload['total_wall_s']}s) on {payload['device']}")
    for _, holds, msg in gates(payload, done):
        gate(holds, msg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
