#!/usr/bin/env python3
"""Fleet bench of the PyTorch port: replica scaling, burst tails, shedding,
recovery (BENCH_fleet_torch.json); the twin of ``scripts/bench_fleet.py``
over :mod:`repro_torch.fleet`.

Four experiments against the supervised fleet tier:

1. **Scaling** — the same workload at 1, 2 and 4 replicas; reports tokens/s
   per replica count.  Workers run the deterministic toy engine whose
   per-token cost is a *service-time sleep* (it releases the core), so
   throughput measures the fleet tier itself — router, supervisor loop,
   pipe transport — not the card.  ``--real`` swaps in the port's
   continuous engine on ``--device`` (each replica a process with its own
   CUDA context and weights; a first unmeasured pass captures each
   replica's prefill bucket); ``--full`` serves the arch's published
   config instead of its smoke config.
2. **Burst tail** — steady arrivals with a 4x burst in the middle; p50/p99
   per-request latency across the fleet.
3. **Recovery** — SIGKILL one of 4 replicas mid-decode; reports time from
   failure detection to the first token streamed after it (token times and
   the fleet's events on one clock), plus a bit-exactness check of every
   stream against the pure-function reference (toy mode).
4. **Shedding** — offered load at 2x a single replica's capacity with a
   small admission cap: accepted-request p99 must stay bounded (the
   in-runtime analogue is ``Runtime.lease(shed_after_s=...)``).  Always
   toy workers, as the original.

    python3 scripts/torch_bench_fleet.py [--out FILE]
    python3 scripts/torch_bench_fleet.py --real [--full] [--device cuda]

The JSON holds the device (on the card, its name and ``nvidia-smi``'s name
and power limit) and is written before the gates run.

Smoke gates (the original's, toy mode):
  * 4-replica tokens/s >= 3x 1-replica tokens/s;
  * kill drill: zero lost requests, every stream bit-identical;
  * recovery gap < 10x steady-state p50 token gap (floor 50 ms);
  * shed run: accepted p99 <= 2x the unshed burst p99 bound.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fleet import FaultInjector, FaultSpec, Fleet, FleetConfig  # noqa: E402
from repro_torch.fleet.worker import toy_next_token  # noqa: E402

VOCAB = 211
SERVICE_S = 0.004        # per decode step per replica (sleep — releases core)


def gate(cond, msg):
    """Acceptance gate that survives ``python -O`` (no bare asserts)."""
    if not cond:
        raise SystemExit(f"GATE FAILED: {msg}")


def device_info(args) -> dict:
    """Where the numbers were taken: the CPU for toy workers on a machine
    without a card, else the card's name and ``nvidia-smi``'s name and power
    limit (a card may be set below 700 W)."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        smi = None
    if args.real and args.device == "cpu" or smi is None or smi.returncode != 0:
        return {"type": "cpu", "name": "cpu", "workers": "real" if args.real else "toy"}
    return {"type": "cuda", "name_power_limit": smi.stdout.strip().splitlines()[0],
            "workers": "real" if args.real else "toy"}


def fleet_cfg(n_workers: int, args, *, real: bool, max_inflight: int = 4) -> FleetConfig:
    if real:
        engine = {"kind": "continuous", "arch": args.arch, "smoke": not args.full,
                  "max_batch": max_inflight, "device": args.device,
                  "calibration_store": args.calibration_store}
        if not args.full:
            engine["reduced_vocab"] = VOCAB
    else:
        engine = {"kind": "toy", "vocab_size": VOCAB,
                  "service_time_s": SERVICE_S}
    # real engines capture their prefill buckets on their first post-ready
    # steps, and heartbeats ride the serve loop: the liveness window must
    # cover a capture-length step (see launch/serve.serve_fleet)
    return FleetConfig(n_workers=n_workers, engine=engine,
                       heartbeat_s=0.5 if real else 0.05,
                       liveness_s=120.0 if real else None,
                       startup_grace_s=600.0 if real else 30.0,
                       max_inflight_per_worker=max_inflight)


def workload(n_requests: int, *, rate: float, max_new: int, seed: int = 0):
    """(arrival_time, prompt, max_new) with Poisson arrivals (rate=0: t=0)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n_requests):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(4, 12))
        prompt = [int(x) for x in rng.integers(1, VOCAB, size=plen)]
        out.append((t, prompt, max_new))
    return out


def drive(fleet: Fleet, arrivals, *, injector=None, timeout_s=600.0):
    """Feed arrivals at their times; returns (done, latency_by_rid, wall,
    token_times).  Latency = completion - arrival; token times and the
    fleet's event times are both seconds since the fleet started."""
    fleet.wait_ready()
    t0 = time.monotonic()
    todo = list(arrivals)
    arrive: dict[int, float] = {}
    finish: dict[int, float] = {}
    token_times: list[float] = []
    fleet.on_token = lambda rid, tok, idx: token_times.append(
        time.monotonic() - fleet._t0)
    deadline = t0 + timeout_s
    while todo or fleet.has_work:
        if time.monotonic() > deadline:
            raise SystemExit(f"bench drive timed out after {timeout_s}s")
        now = time.monotonic() - t0
        while todo and todo[0][0] <= now:
            t, prompt, max_new = todo.pop(0)
            arrive[fleet.submit(prompt, max_new)] = t
        fleet.pump()
        if injector is not None:
            injector.tick(fleet)
        for req in fleet.completed:
            if req.rid not in finish:
                finish[req.rid] = time.monotonic() - t0
    done = sorted(fleet.completed, key=lambda r: r._order)
    fleet.completed = []
    for req in done:
        finish.setdefault(req.rid, time.monotonic() - t0)
    lat = {rid: finish[rid] - arrive[rid] for rid in finish}
    return done, lat, time.monotonic() - t0, token_times


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0


def check_streams(done) -> None:
    for r in done:
        ref = []
        for _ in range(r.max_new):
            ref.append(toy_next_token(r.prompt, ref, VOCAB, seed=0))
        gate(list(r.tokens) == ref,
             f"request {r.rid} stream diverged from reference "
             f"(requeues={r.n_requeues})")
        gate(len(r.tokens) == r.max_new,
             f"request {r.rid} truncated: {len(r.tokens)}/{r.max_new}")


def bench_scaling(args) -> dict:
    out = {}
    work = workload(args.requests, rate=0.0, max_new=args.max_new)
    for n in (1, 2, 4):
        t_boot = time.monotonic()
        with Fleet(fleet_cfg(n, args, real=args.real)) as fleet:
            fleet.wait_ready()
            boot = time.monotonic() - t_boot
            first = None
            if args.real:
                # one unmeasured pass: each replica captures its prefill
                # bucket on its first steps, which the timed pass leaves out
                first = drive(fleet, work)[2]
            done, lat, wall, _ = drive(fleet, work)
            boots = [b["boot_s"] for b in fleet.boots]
        toks = sum(len(r.tokens) for r in done)
        if not args.real:
            check_streams(done)
        out[str(n)] = {"tokens_per_s": toks / wall, "wall_s": wall,
                       "n_done": len(done), "boot_wall_s": boot,
                       "replica_boot_s": boots, "first_pass_wall_s": first}
        print(f"scaling: {n} replica(s): {toks / wall:.1f} tok/s "
              f"({len(done)} requests, {wall:.2f}s; boot {boot:.1f}s"
              + (f", first pass {first:.2f}s)" if first is not None else ")"))
    return out


def bench_burst(args) -> dict:
    steady = workload(args.requests, rate=args.rate, max_new=args.max_new)
    burst_at = steady[len(steady) // 2][0]
    burst = [(burst_at, p, m) for _, p, m in
             workload(args.requests // 2, rate=0.0, max_new=args.max_new,
                      seed=7)]
    work = sorted(steady + burst, key=lambda x: x[0])
    with Fleet(fleet_cfg(4, args, real=args.real)) as fleet:
        done, lat, wall, _ = drive(fleet, work)
    if not args.real:
        check_streams(done)
    res = {"p50_s": percentile(list(lat.values()), 0.50),
           "p99_s": percentile(list(lat.values()), 0.99),
           "n_done": len(done), "wall_s": wall}
    print(f"burst: p50={res['p50_s'] * 1e3:.0f}ms p99={res['p99_s'] * 1e3:.0f}ms "
          f"({len(done)} requests)")
    return res


def bench_recovery(args) -> dict:
    work = workload(args.requests, rate=args.rate, max_new=args.max_new)
    with Fleet(fleet_cfg(4, args, real=args.real)) as fleet:
        inj = FaultInjector(
            [FaultSpec(kind="kill", at_tokens=args.requests * args.max_new // 4)],
            seed=args.seed)
        done, lat, wall, token_times = drive(fleet, work, injector=inj)
        stats = fleet.stats()
        events = list(fleet.events)
    gate(len(done) == len(work), f"lost requests: {len(done)}/{len(work)}")
    if not args.real:
        check_streams(done)
    gate(stats["n_failovers"] >= 1, "kill fault never fired")
    # recovery gap: the first token streamed after the failure vs the
    # steady-state p50 inter-token gap
    fail_t = next(t for t, kind, _, _ in events if kind == "fail")
    gaps = np.diff(token_times)
    steady_p50 = float(np.median(gaps)) if len(gaps) else 0.0
    after = [t for t in token_times if t >= fail_t]
    recovery = (after[0] - fail_t) if after else 0.0
    res = {"recovery_s": recovery, "steady_p50_gap_s": steady_p50,
           "n_requeued": stats["n_requeued"],
           "n_failovers": stats["n_failovers"], "faults": inj.log}
    print(f"recovery: {recovery * 1e3:.0f}ms to the first token after the failure "
          f"(steady p50 gap {steady_p50 * 1e3:.1f}ms, "
          f"requeued {stats['n_requeued']})")
    return res


def bench_shed(args) -> dict:
    """2x-overload: a single replica with a tiny admission cap; offered
    load outruns it, the queue backs up, and the supervisor-side cap keeps
    accepted-request latency bounded by rejecting the excess up front."""
    cap = 8
    # one replica drains max_inflight requests concurrently, one token per
    # service tick: capacity = 4 / (SERVICE_S * max_new) requests/s
    rate = 2.0 * 4 / (SERVICE_S * args.max_new)
    work = workload(args.requests * 2, rate=rate, max_new=args.max_new,
                    seed=3)
    rejected = 0
    with Fleet(fleet_cfg(1, args, real=False, max_inflight=4)) as fleet:
        fleet.wait_ready()
        t0 = time.monotonic()
        todo = list(work)
        arrive: dict[int, float] = {}
        finish: dict[int, float] = {}
        while todo or fleet.has_work:
            now = time.monotonic() - t0
            while todo and todo[0][0] <= now:
                t, prompt, max_new = todo.pop(0)
                backlog = len(fleet._pending) + sum(
                    len(w.inflight) for w in fleet._workers.values())
                if backlog >= cap:
                    rejected += 1            # 429: retry elsewhere/later
                    continue
                arrive[fleet.submit(prompt, max_new)] = t
            fleet.pump()
            for req in fleet.completed:
                finish.setdefault(req.rid, time.monotonic() - t0)
    accepted_lat = [finish[r] - arrive[r] for r in finish]
    res = {"accepted": len(accepted_lat), "rejected": rejected,
           "p50_s": percentile(accepted_lat, 0.50),
           "p99_s": percentile(accepted_lat, 0.99)}
    print(f"shed: accepted={res['accepted']} rejected={rejected} "
          f"p99={res['p99_s'] * 1e3:.0f}ms")
    return res


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="BENCH_fleet_torch.json")
    # 32 = full waves at every replica count (1 rep: 8 waves of 4; 4 reps:
    # 2 waves of 16), so the ideal scaling ratio is 4.0x, not quantized down
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--rate", type=float, default=60.0,
                   help="steady Poisson arrival rate (requests/s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--real", action="store_true",
                   help="the port's continuous engine in each worker instead of "
                        "the toy (service-time) worker")
    p.add_argument("--full", action="store_true",
                   help="with --real: the arch's published config, not its smoke "
                        "config")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --real workers run (default: the card)")
    p.add_argument("--arch", default="gemma-2b")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.real = args.real or args.full
    with tempfile.TemporaryDirectory() as tmp:
        # one calibration store for every real fleet of the run: the first
        # boot calibrates, every later boot loads it
        args.calibration_store = os.path.join(tmp, "calibration.json")
        t0 = time.monotonic()
        results = {
            "mode": ("real-full" if args.full else "real") if args.real
            else "toy-service-time",
            "device": device_info(args),
            "arch": args.arch if args.real else None,
            "scaling": bench_scaling(args),
            "burst": bench_burst(args),
            "recovery": bench_recovery(args),
            "shed": bench_shed(args),
        }
        results["total_wall_s"] = time.monotonic() - t0

    sc = results["scaling"]
    speedup = sc["4"]["tokens_per_s"] / max(sc["1"]["tokens_per_s"], 1e-9)
    results["speedup_4v1"] = speedup
    results["speedup_2v1"] = sc["2"]["tokens_per_s"] / max(sc["1"]["tokens_per_s"], 1e-9)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    print(f"4v1 speedup {speedup:.2f}x, 2v1 {results['speedup_2v1']:.2f}x -> {args.out} "
          f"on {results['device']}")
    if not args.real:
        gate(speedup >= 3.0, f"4-replica speedup {speedup:.2f}x < 3x")
        rec = results["recovery"]
        gate(rec["recovery_s"] < 10 * max(rec["steady_p50_gap_s"], 0.05),
             f"recovery {rec['recovery_s']:.3f}s >= 10x steady p50 gap")
        gate(results["shed"]["p99_s"] <= 2 * results["burst"]["p99_s"]
             + 10 * SERVICE_S * args.max_new,
             "shed p99 unbounded despite admission cap")
    else:
        print("note: --real mode skips the scaling/recovery gates "
              "(host-bound, machine-dependent)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
