#!/usr/bin/env python3
"""Scheduler-overhead bench of the PyTorch port: the dynamic HostScheduler
vs compiled static host plans (BENCH_sched_torch.json); the twin of
``scripts/bench_sched_overhead.py``.

Legs, each on one persistent :class:`ExecutorPool` or one Runtime:

1. **Decode-graph microbench**: a decode-shaped DAG (24 layers of 4
   parallel ops feeding a join) with ~free op fns, replayed R times through
   both runtimes.  With op cost ~0, wall time per op *is* per-op
   scheduling overhead.  On the card the executors are CUDA streams fed by
   host threads, and the ops touch no tensor.
2. **Serve decode step**: the captured decode graph of a model
   (``jit_nodes=True``, the ContinuousEngine's configuration), calibrated
   as the engine calibrates it; per-token step wall time, dynamic vs
   static, same Executable, same executors, modes interleaved.
3. **check="strict" build cost**: host-plan build time with and without
   the structural verifier (``repro_torch.checks`` S-* / P-* rules).
4. **Schedule search** (``repro_torch.core.search``): every registered
   policy scored on two captured model-family decode graphs at several
   executor configs, and the searched decode plan's outputs against the
   CPF plan's.

    python3 scripts/torch_bench_sched_overhead.py [--device cpu] [--out FILE]
    python3 scripts/torch_bench_sched_overhead.py --arch yi-9b --full

By default the original's models: the smoke gemma-2b (vocabulary 128) for
the decode step and the smoke gemma-2b and olmoe-1b-7b for the search;
``--arch NAME --full`` runs the decode step and the search on that config
at full width.  The cost model is the card's (H100) on the card and the
original's KNL7250 on the CPU.  The JSON is written before the gates run.

Gates (the original's):
  * microbench: static per-op overhead >= 1.5x lower than dynamic (speed);
  * every measured static microbench run equals the sequential
    ``Graph.execute`` oracle, and the dynamic run too;
  * decode step: static and dynamic outputs identical; static no more than
    10% slower than dynamic (speed);
  * check="strict" adds < 10% to plan-build time (speed);
  * schedule search: winner <= the CPF makespan on every (family, config);
    >= 1 family / config where a non-CPF policy strictly wins; the searched
    plan's decode outputs bit-exact against the CPF plan's.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SEARCH_FAMILIES = ("gemma-2b", "olmoe-1b-7b")
# configs narrower than the profiled best: contended widths are where the
# priority heuristic actually decides the makespan (at the profiler's wide
# optimum every policy saturates and ties)
SEARCH_CONFIGS = ((2, 8), (4, 4))


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


def hw_for(device):
    from repro_torch.core.cost_model import H100, KNL7250

    return H100 if device.type == "cuda" else KNL7250


def bench_micro(repeats: int, n_exec: int, device) -> dict:
    from repro_torch.core.engine import ExecutorPool, HostScheduler
    from repro_torch.core.scheduler import make_schedule
    from repro_torch.core.static_host import compile_host_plan, layered_graph

    hw = hw_for(device)
    g = layered_graph(L=24, W=4)
    oracle = g.execute({"x": 1.0})
    sched = make_schedule(g, hw, n_executors=n_exec, team_size=1)
    plan = compile_host_plan(g, sched)
    n_ops = plan.n_ops
    dyn_ok = stat_ok = True
    with ExecutorPool(n_exec, device=device) as pool:
        host = HostScheduler(g, n_exec, costs=sched.op_costs, pool=pool)
        for _ in range(5):                              # warmup both paths
            host.run({"x": 1.0})
            plan.run({"x": 1.0}, pool=pool)
        dyn: list[float] = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = host.run({"x": 1.0})
            dyn.append(time.perf_counter() - t0)
        dyn_ok = res.outputs == oracle
        stat: list[float] = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = plan.run({"x": 1.0}, pool=pool)
            stat.append(time.perf_counter() - t0)
            stat_ok = stat_ok and res.outputs == oracle
    dyn_op = statistics.median(dyn) / n_ops
    stat_op = statistics.median(stat) / n_ops
    return {
        "bench": "decode_micro",
        "n_ops": n_ops,
        "n_executors": n_exec,
        "repeats": repeats,
        "dynamic_per_op_us": round(dyn_op * 1e6, 3),
        "static_per_op_us": round(stat_op * 1e6, 3),
        "overhead_ratio_x": round(dyn_op / stat_op, 3),
        "dynamic_equals_oracle": dyn_ok,
        "static_equals_oracle": stat_ok,
    }


def bench_check_overhead(repeats: int, n_exec: int, device) -> dict:
    """``check="strict"`` cost: host-plan build time with vs without the
    structural verifier on the bench decode graph."""
    from repro_torch.checks import check_plan, check_schedule
    from repro_torch.core.scheduler import make_schedule
    from repro_torch.core.static_host import compile_host_plan, layered_graph

    hw = hw_for(device)
    g = layered_graph(L=24, W=4)

    def build():
        sched = make_schedule(g, hw, n_executors=n_exec, team_size=1)
        return sched, compile_host_plan(g, sched)

    build()                                             # warm caches
    plain: list[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        build()
        plain.append(time.perf_counter() - t0)
    strict: list[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sched, plan = build()
        rep = check_schedule(sched, g)
        rep.extend(check_plan(plan, g))
        rep.raise_if_errors()
        strict.append(time.perf_counter() - t0)
    p, s = statistics.median(plain), statistics.median(strict)
    return {
        "bench": "strict_check_overhead",
        "n_nodes": len(g),
        "n_executors": n_exec,
        "repeats": repeats,
        "plain_build_ms": round(p * 1e3, 3),
        "strict_build_ms": round(s * 1e3, 3),
        "overhead_pct": round((s / p - 1.0) * 100.0, 2),
    }


def model(arch: str, full: bool, device):
    """The config (full width, or the smoke config with a 128-token
    vocabulary) and random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch) if full else get_config(arch, smoke=True).reduced(vocab_size=128)
    return cfg, transformer.init_params(cfg, 0, device=device)


def decode_inputs(cfg, device, B: int = 4, max_len: int = 32):
    import torch

    from repro_torch.models import transformer

    cache = transformer.init_cache(cfg, B, max_len, per_slot=True, device=device)
    return cache, torch.ones((B, 1), dtype=torch.int32, device=device)


def _leaves(out) -> list:
    from torch.utils import _pytree as pytree

    return [t.detach().clone() for t in pytree.tree_leaves(out)]


def bench_decode_step(steps: int, arch: str, full: bool, device) -> dict:
    import torch

    from repro_torch import api
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step

    cfg, params = model(arch, full, device)
    cache, toks = decode_inputs(cfg, device)
    # the production wiring: one Runtime owns the executors, the decode
    # executable leases its calibrated width per run (admission overhead is
    # paid identically by both modes, so the ratio stays a pure
    # scheduler-overhead measurement)
    with Runtime(device=device) as rt:
        exe = api.compile(make_decode_step(cfg), params, cache, toks, hw=hw_for(device),
                          backend="host", jit_nodes=True, name="bench_decode", runtime=rt)
        # profile-guided config + plan, exactly as the serve engine builds
        # them: measured per-op costs drive the executor-count search and
        # the schedule the static plan freezes
        exe.calibrate(params, cache, toks)
        n_exec = min(exe.planned_executors, rt.n_workers)
        inputs = exe.captured.bind((params, cache, toks))
        walls: dict[str, list[float]] = {"dynamic": [], "static": []}
        outs = {}
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        for mode in walls:                                      # warmup
            exe.execute_host(inputs, host_mode=mode)
        sync()
        # interleave the modes so drift on a shared host hits both equally
        for _ in range(steps):
            for mode in walls:
                t0 = time.perf_counter()
                res = exe.execute_host(inputs, host_mode=mode)
                sync()
                walls[mode].append(time.perf_counter() - t0)
                outs[mode] = _leaves(exe.captured.unflatten(res.outputs))
        n_ops = exe.host_plan(n_exec).n_ops
    dyn = statistics.median(walls["dynamic"])
    stat = statistics.median(walls["static"])
    return {
        "bench": "serve_decode_step",
        "arch": cfg.name,
        "full": full,
        "n_nodes": len(exe.graph),
        "n_ops": n_ops,
        "n_executors": n_exec,
        "steps": steps,
        "dynamic_step_ms": round(dyn * 1e3, 3),
        "static_step_ms": round(stat * 1e3, 3),
        "speedup_x": round(dyn / stat, 3),
        "static_equals_dynamic": all(torch.equal(a, b)
                                     for a, b in zip(outs["static"], outs["dynamic"])),
    }


def bench_schedule_search(families, full: bool, device) -> dict:
    """Score every registered policy on captured model-family decode graphs;
    record per-policy simulated makespans and the winner, and run the
    searched decode plan against the CPF baseline for the same outputs."""
    import torch

    from repro_torch import api
    from repro_torch.core.policies import list_policies
    from repro_torch.core.search import search_schedule
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_decode_step

    hw = hw_for(device)
    out_families: dict[str, dict] = {}
    strict_wins: list[str] = []
    not_worse = True
    outs = {}
    with Runtime(device=device) as rt:
        for arch in families:
            cfg, params = model(arch, full, device)
            cache, toks = decode_inputs(cfg, device)
            exe = api.compile(make_decode_step(cfg), params, cache, toks, hw=hw, backend="sim",
                              jit_nodes=True, schedule_search="off", runtime=rt,
                              name=f"sched_search[{arch}]")
            costs = exe.profile.op_costs
            configs = []
            for n, k in SEARCH_CONFIGS:
                res = search_schedule(exe.graph, hw, n_executors=n, team_size=k, costs=costs)
                not_worse = not_worse and res.makespan_sim <= res.cpf_makespan + 1e-15
                if res.policy != "cpf" and res.makespan_sim < res.cpf_makespan * (1.0 - 1e-9):
                    strict_wins.append(f"{arch}@{n}x{k}:{res.policy}")
                configs.append({
                    "config": f"{n}x{k}",
                    "winner": res.policy,
                    "seed": res.seed,
                    "winner_makespan_us": round(res.makespan_sim * 1e6, 4),
                    "cpf_makespan_us": round(res.cpf_makespan * 1e6, 4),
                    "gain_over_cpf_pct": round(100.0 * res.gain_over_cpf, 3),
                    "runner_up_gap_pct": round(100.0 * res.runner_up_gap, 3),
                    "per_policy_makespan_us": {p: round(m * 1e6, 4)
                                               for p, m in res.by_policy().items()},
                })
            out_families[arch] = {"n_nodes": len(exe.graph), "width": exe.graph.width(),
                                  "configs": configs}
            del params, cache

        # decode bit-exactness: the searched plan vs the CPF baseline
        n, k = SEARCH_CONFIGS[0]
        cfg, params = model(families[0], full, device)
        cache, toks = decode_inputs(cfg, device)
        for mode in ("off", "force"):
            exe = api.compile(make_decode_step(cfg), params, cache, toks, hw=hw,
                              backend="host", jit_nodes=True, host_mode="static",
                              n_executors=n, team_size=k, runtime=rt, schedule_search=mode,
                              name=f"bitexact[{mode}]")
            res = exe.execute_host(exe.captured.bind((params, cache, toks)))
            outs[mode] = _leaves(exe.captured.unflatten(res.outputs))
    bit_exact = all(torch.equal(a, b) for a, b in zip(outs["off"], outs["force"]))
    return {
        "bench": "schedule_search",
        "policies": list_policies(),
        "families": out_families,
        "strict_wins": strict_wins,
        "winner_not_worse_than_cpf": not_worse,
        "decode_bit_exact_vs_cpf": bit_exact,
    }


def run(args) -> dict:
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    families = (args.arch,) if args.full else SEARCH_FAMILIES
    t0 = time.time()
    micro = bench_micro(args.repeats, args.executors, dev)
    step = bench_decode_step(args.steps, args.arch, args.full, dev)
    strict = bench_check_overhead(args.repeats, args.executors, dev)
    search = bench_schedule_search(families, args.full, dev)
    return {"total_wall_s": round(time.time() - t0, 2),
            "device": {**card(dev), "hw_model": hw_for(dev).name},
            "rows": [micro, step, strict],
            "schedule_search": search}


def gates(payload: dict) -> list[tuple[str, bool, str]]:
    """(kind, holds, message) of every gate; kind ``"parity"``, ``"search"``
    or ``"speed"`` (the speed thresholds were set on a CPU host)."""
    micro, step, strict = payload["rows"]
    search = payload["schedule_search"]
    return [
        ("parity", micro["dynamic_equals_oracle"], "dynamic run diverged from the oracle"),
        ("parity", micro["static_equals_oracle"],
         "static run not bit-identical to Graph.execute"),
        ("parity", step["static_equals_dynamic"],
         "decode step output diverged between static and dynamic modes"),
        ("search", search["winner_not_worse_than_cpf"],
         "a searched winner is worse than CPF"),
        ("search", bool(search["strict_wins"]),
         "no (family, config) where a non-CPF policy strictly beat CPF"),
        ("parity", search["decode_bit_exact_vs_cpf"],
         "decode outputs diverged between the searched plan and CPF"),
        ("speed", micro["overhead_ratio_x"] >= 1.5,
         f"static per-op overhead only {micro['overhead_ratio_x']}x lower than dynamic "
         f"(need >= 1.5x)"),
        # real compute dominates the decode step, so the overhead win shrinks
        # to its scheduling share: a no-regression guard with tolerance
        ("speed", step["static_step_ms"] <= 1.1 * step["dynamic_step_ms"],
         f"static decode step {step['static_step_ms']}ms regressed vs dynamic "
         f"{step['dynamic_step_ms']}ms (> 10%)"),
        ("speed", strict["strict_build_ms"] <= 1.1 * strict["plain_build_ms"],
         f"check=strict plan build {strict['strict_build_ms']}ms is {strict['overhead_pct']}% "
         f"over plain {strict['plain_build_ms']}ms (gate: < 10%)"),
    ]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="BENCH_sched_torch.json")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--full", action="store_true",
                   help="decode step and search on the arch's published config")
    p.add_argument("--repeats", type=int, default=40)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--executors", type=int, default=4)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    payload = run(args)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    micro, step, strict = payload["rows"]
    search = payload["schedule_search"]
    print(f"{micro['bench']:18s} dyn={micro['dynamic_per_op_us']:8.2f}us/op "
          f"static={micro['static_per_op_us']:8.2f}us/op ratio={micro['overhead_ratio_x']:.2f}x")
    print(f"{step['bench']:18s} dyn={step['dynamic_step_ms']:8.2f}ms/tok "
          f"static={step['static_step_ms']:8.2f}ms/tok speedup={step['speedup_x']:.2f}x")
    print(f"{strict['bench']:18s} plain={strict['plain_build_ms']:8.2f}ms "
          f"strict={strict['strict_build_ms']:8.2f}ms overhead={strict['overhead_pct']:+.1f}%")
    for arch, fam in search["families"].items():
        for c in fam["configs"]:
            print(f"schedule_search    {arch:12s} {c['config']:4s} "
                  f"winner={c['winner']}@{c['seed']} gain={c['gain_over_cpf_pct']:+.3f}% "
                  f"runner_up_gap={c['runner_up_gap_pct']:.3f}%")
    print(f"schedule_search    strict_wins={search['strict_wins']} "
          f"bit_exact={search['decode_bit_exact_vs_cpf']}")
    print(f"wrote {args.out} ({payload['total_wall_s']}s) on {payload['device']}")
    for _, holds, msg in gates(payload):
        gate(holds, msg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
