"""Serving CLI: ``python -m repro_torch.launch.serve --arch gemma-2b --smoke``.

Builds a (randomly initialized) model on the card (``--device cpu`` for the
CPU), submits synthetic requests, and reports decode throughput and
per-request latency.  The default is the wave batcher; ``--continuous``
routes through the Graphi-scheduled per-slot :class:`ContinuousEngine`
(prefill and decode captured via ``repro_torch.compile``, profiler-chosen
executor config, slot admission between decode steps, decode replayed
through a compiled static host plan unless ``--decode-host-mode
dynamic``); ``--paged`` through the block-paged :class:`PagedEngine`.
``--arrival-rate`` staggers request arrivals (Poisson, requests/second)
instead of submitting everything up front.

``--arch`` takes every ported config: the dense decoders gemma-2b, yi-9b,
h2o-danube3-4b and command-r-plus-104b (parallel blocks; ~214 GB at full
width, more than one H100 holds), the MoE archs (granite-moe-1b-a400m,
olmoe-1b-7b), falcon-mamba-7b and recurrentgemma-2b; ``--paged`` refuses
the last two, whose recurrent state has no paged cache, with the
reference's message.  The frontend archs behave as in the reference's CLI:
llava-next-34b is served as text by the wave engine and whisper-medium is
refused there (a request carries no encoder frames); ``--continuous`` and
``--paged`` refuse both.  Their embeddings reach the model through
``serve.step``'s prefill and decode steps (``chip_smoke.py`` drives them).

``--check basic|strict`` verifies the continuous and paged engines'
captured graphs before the first request (:mod:`repro_torch.checks`: graph,
schedule, host plan and buffer hazards of the decode graph and of the
chunk-prefill graph, and the paged decode × chunk pair over the engine's
one page pool); ``strict`` refuses to serve on an error finding.
``--pinning auto|on`` pins the runtime's executor threads to disjoint host
cores (:mod:`repro_torch.hwperf`; on the card, each stream's launcher).

``--replicas N`` (N > 1) serves through the supervised fleet
(:mod:`repro_torch.fleet`): N worker processes, each a replica with its own
CUDA context and weights (``--replica-engine``: the engine ``--paged`` /
``--continuous`` selects, or the toy worker), heartbeat liveness, and
failover that replays a dead replica's requests on a live one.
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models import transformer
from repro_torch.serve.engine import (ContinuousEngine, Request, ServeConfig, ServeEngine,
                                     refuse_encoder, refuse_frontend)
from repro_torch.serve.paged import PagedConfig, PagedEngine, refuse_unpaged


def build_requests(cfg, *, n_requests, prompt_lens, max_new,
                   arrival_rate=0.0, seed=0) -> list[tuple[float, Request]]:
    """(arrival_time, request) pairs: Poisson arrivals (all at t=0 when
    ``arrival_rate`` is 0), prompt lengths cycled from ``prompt_lens``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        prompt = rng.integers(
            1, cfg.vocab_size, size=prompt_lens[i % len(prompt_lens)]
        ).astype(np.int32)
        out.append((t, Request(request_id=i, prompt=prompt, max_new_tokens=max_new)))
    return out


def percentile(xs, q: float) -> float:
    """Index-based percentile of a sequence (0.0 when empty)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def drive(engine, arrivals: list[tuple[float, Request]], *, continuous: bool):
    """Feed requests at their arrival times; returns (done, latency, wall).

    The wave engine drains its queue whenever it is idle and work has
    arrived (one ``run()`` per busy period); the continuous engines step,
    admitting arrivals between decode steps.
    """
    t0 = time.perf_counter()
    todo = list(arrivals)
    done: list[Request] = []
    finish: dict[int, float] = {}
    while True:
        now = time.perf_counter() - t0
        while todo and todo[0][0] <= now:
            engine.submit(todo.pop(0)[1])
        if engine.has_work:
            if continuous:
                engine.step()
                for r in engine.completed:
                    if r.request_id not in finish:
                        finish[r.request_id] = time.perf_counter() - t0
            else:
                batch = engine.run()
                stamp = time.perf_counter() - t0
                for r in batch:
                    finish[r.request_id] = stamp
                    done.append(r)
        elif todo:
            time.sleep(max(0.0, todo[0][0] - (time.perf_counter() - t0)))
        else:
            break
    if continuous:
        done = engine.run()
    arrive = {r.request_id: t for t, r in arrivals}
    lat = {r.request_id: finish[r.request_id] - arrive[r.request_id] for r in done}
    return done, lat, time.perf_counter() - t0


def serve_fleet(args) -> int:
    """``--replicas N``: the supervised multi-replica tier.

    Spawns N worker processes under a :class:`repro_torch.fleet.Fleet` —
    heartbeat liveness, crash/wedge failover with replay of ``prompt +
    emitted``, prefix-affinity routing — and drives the same Poisson
    workload through it.  Workers default to real engines of the requested
    kind on ``--device`` (sharing one JSON calibration store so replica
    2..N and every respawn skip the calibration); ``--replica-engine toy``
    swaps in the deterministic service-time worker the fleet tests and bench
    use.
    """
    from repro_torch.device import resolve_device
    from repro_torch.fleet import Fleet, FleetConfig

    kind = args.replica_engine
    if kind == "auto":
        kind = "paged" if args.paged else "continuous"
    prompt_lens = [int(x) for x in str(args.prompt_len).split(",")]
    if kind == "toy":
        vocab = 256
        engine = {"kind": "toy", "vocab_size": vocab, "service_time_s": 0.004}
    else:
        cfg = get_config(args.arch, smoke=args.smoke)
        refuse = refuse_unpaged if kind == "paged" else refuse_frontend
        try:                  # in the parent: before any replica is spawned
            refuse(cfg)
            resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            raise SystemExit(str(e)) from None
        vocab = cfg.vocab_size
        engine = {"kind": kind, "arch": args.arch, "smoke": args.smoke,
                  "max_batch": args.max_batch,
                  "max_len": max(prompt_lens) + args.max_new + 1,
                  "calibration_store": args.calibration_store,
                  "device": args.device}
    arrivals = build_requests(SimpleNamespace(vocab_size=vocab), n_requests=args.requests,
                              prompt_lens=prompt_lens, max_new=args.max_new,
                              arrival_rate=args.arrival_rate)
    work = [(t, [int(x) for x in r.prompt], args.max_new) for t, r in arrivals]

    # real engines capture their prefill buckets on the *first* steps after
    # ready, and heartbeats ride the serve loop — the liveness window must
    # cover a capture-length step or the supervisor declares every healthy
    # replica wedged and burns the restart budget
    if kind == "toy":
        fcfg = FleetConfig(n_workers=args.replicas, engine=engine,
                           max_inflight_per_worker=args.max_batch)
    else:
        fcfg = FleetConfig(n_workers=args.replicas, engine=engine,
                           max_inflight_per_worker=args.max_batch,
                           heartbeat_s=0.5, liveness_s=120.0,
                           startup_grace_s=600.0)
    with Fleet(fcfg) as fleet:
        fleet.wait_ready()
        t0 = time.perf_counter()
        todo, arrive, finish = list(work), {}, {}
        while todo or fleet.has_work:
            now = time.perf_counter() - t0
            while todo and todo[0][0] <= now:
                at, prompt, max_new = todo.pop(0)
                arrive[fleet.submit(prompt, max_new)] = at
            fleet.pump()
            for req in fleet.completed:
                finish.setdefault(req.rid, time.perf_counter() - t0)
        done = sorted(fleet.completed, key=lambda r: r._order)
        wall = time.perf_counter() - t0
        stats = fleet.stats()
    n_tokens = sum(len(r.tokens) for r in done)
    lat = [finish[r.rid] - arrive[r.rid] for r in done]
    print(f"[fleet:{kind} x{args.replicas}] served {len(done)} requests, "
          f"{n_tokens} tokens in {wall:.2f}s ({n_tokens / wall:.1f} tok/s); "
          f"latency p50={percentile(lat, 0.5) * 1e3:.0f}ms "
          f"p95={percentile(lat, 0.95) * 1e3:.0f}ms")
    print(f"  failovers={stats['n_failovers']} requeued={stats['n_requeued']} "
          f"affinity_hits={stats['router_affinity_hits']}/"
          f"{stats['router_routed']}")
    bad = [t for r in done for t in r.tokens if t >= vocab]
    if bad:   # not an assert: the check must survive python -O
        raise SystemExit(f"emitted out-of-vocab ids: {bad[:5]}")
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True,
                   help="a ported config: gemma-2b, yi-9b, h2o-danube3-4b, "
                        "command-r-plus-104b, granite-moe-1b-a400m, olmoe-1b-7b, "
                        "falcon-mamba-7b, recurrentgemma-2b, llava-next-34b (wave, as "
                        "text), whisper-medium (refused by every engine)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default: the card)")
    p.add_argument("--continuous", action="store_true",
                   help="per-slot continuous batching on the Graphi runtime")
    p.add_argument("--paged", action="store_true",
                   help="block-paged KV cache with prefix sharing and chunked "
                        "prefill (implies continuous batching)")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per physical KV page (--paged)")
    p.add_argument("--n-pages", type=int, default=None,
                   help="physical pages in the pool (--paged; default "
                        "max_batch * ceil(max_len/page_size))")
    p.add_argument("--prefill-chunk", type=int, default=64,
                   help="tokens prefilled per engine step per prompt (--paged; "
                        "rounded up to a page multiple)")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson arrival rate (req/s); 0 = all at once")

    def _positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("need at least 1 request")
        return n

    p.add_argument("--requests", type=_positive, default=8)
    p.add_argument("--prompt-len", default="32",
                   help="prompt length, or comma list for mixed lengths")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-executors", type=int, default=None,
                   help="bound the profiler's executor-config search")
    p.add_argument("--decode-host-mode", choices=("static", "dynamic"), default="static",
                   help="decode-graph runtime: compiled static host plan (default) or "
                        "the per-op dynamic scheduler")
    p.add_argument("--runtime-workers", type=int, default=None,
                   help="executor count of the process Runtime (default: sized from "
                        "the card; the core count on the CPU)")
    p.add_argument("--calibration-store", default=None,
                   help="JSON path backing the Runtime's calibration store (measured "
                        "op costs survive restarts)")
    p.add_argument("--pinning", choices=("off", "auto", "on"), default="off",
                   help="pin executor threads to disjoint core sets "
                        "(repro_torch.hwperf; on the card, each stream's launcher "
                        "thread): 'auto' pins where the platform supports affinity, "
                        "'on' warns once where it doesn't (continuous/paged only)")
    p.add_argument("--dump-trace", choices=("ascii", "csv"), default=None,
                   help="print the decode executable's last execution timeline "
                        "(measured if available, else simulated) after serving "
                        "(continuous/paged only)")
    p.add_argument("--schedule-search", choices=("off", "auto", "force"), default="auto",
                   help="simulator-guided schedule search over registered policies: "
                        "'auto' (default) once the decode graph is calibrated, 'force' "
                        "always, 'off' plain CPF (continuous/paged only)")
    p.add_argument("--check", choices=("off", "basic", "strict"), default="off",
                   help="static verification (repro_torch.checks) of the engine's "
                        "captured graphs/schedules/plans after build: 'basic' "
                        "reports, 'strict' additionally refuses to serve on error "
                        "findings (continuous/paged only)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a supervised multi-replica fleet (worker "
                        "processes, heartbeat failover, requeue with replay) "
                        "instead of one in-process engine")
    p.add_argument("--replica-engine", choices=("auto", "toy", "continuous", "paged"),
                   default="auto",
                   help="fleet worker engine (--replicas > 1): 'auto' follows "
                        "--paged/--continuous, 'toy' is the deterministic "
                        "service-time worker")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.replicas > 1:
        return serve_fleet(args)

    from repro_torch.device import resolve_device
    from repro_torch.runtime import Runtime, set_default_runtime

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    continuous = args.continuous or args.paged
    refuse = refuse_unpaged if args.paged else refuse_frontend if continuous else refuse_encoder
    try:                      # before building the weights: the engine's refusal
        refuse(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    params = transformer.init_params(cfg, 0, device=dev)
    prompt_lens = [int(x) for x in str(args.prompt_len).split(",")]
    scfg = ServeConfig(max_batch=args.max_batch, max_len=max(prompt_lens) + args.max_new + 1,
                       temperature=args.temperature)
    runtime = None
    if continuous:
        # one process-wide Runtime: the engine leases its calibrated
        # executor width from it per step instead of owning a pool
        runtime = Runtime(args.runtime_workers, device=dev,
                          calibration_path=args.calibration_store, pinning=args.pinning)
        set_default_runtime(runtime, dev.type)
        common = {"device": dev, "max_executors": args.max_executors, "runtime": runtime,
                  "decode_host_mode": args.decode_host_mode,
                  "schedule_search": args.schedule_search}
        if args.paged:
            pcfg = PagedConfig(page_size=args.page_size, n_pages=args.n_pages,
                               prefill_chunk=args.prefill_chunk)
            engine = PagedEngine(cfg, params, scfg, paged=pcfg, **common)
            print(f"paged engine on {dev}: {engine.n_executors} executors leased of "
                  f"{runtime.n_workers}, {engine.capacity} slots, "
                  f"{engine.page_pool.n_pages} pages x {pcfg.page_size} tok, "
                  f"chunk={engine.chunk}, decode={engine.decode_host_mode}")
        else:
            engine = ContinuousEngine(cfg, params, scfg, **common)
            print(f"continuous engine on {dev}: {engine.n_executors} executors leased of "
                  f"{runtime.n_workers} (profiled best {engine.profile.best_config}), "
                  f"{engine.capacity} slots, decode={engine.decode_host_mode}")
    else:
        engine = ServeEngine(cfg, params, scfg, device=dev)

    if continuous and args.check != "off":
        # verify the engine's captured executables before serving a single
        # request; strict mode refuses to serve over a bad artifact
        from repro_torch.checks.cli import verify_engine

        rep = verify_engine(engine)
        print(f"check[{args.check}]: {rep.summary()}")
        body = rep.render(min_severity="warning")
        if body != "clean: no findings":
            print(body)
        if args.check == "strict":
            rep.raise_if_errors()
    if continuous and runtime.pinning_applied is not None:
        applied = runtime.pinning_applied
        print(f"pinning: {applied.describe()} {applied.plan.describe()}")

    arrivals = build_requests(cfg, n_requests=args.requests, prompt_lens=prompt_lens,
                              max_new=args.max_new, arrival_rate=args.arrival_rate)
    done, lat, wall = drive(engine, arrivals, continuous=continuous)
    n_tokens = sum(len(r.output) for r in done)
    p50 = percentile(lat.values(), 0.50)
    p95 = percentile(lat.values(), 0.95)
    mode = "paged" if args.paged else ("continuous" if continuous else "wave")
    print(f"[{mode}] served {len(done)} requests, {n_tokens} tokens in {wall:.2f}s "
          f"({n_tokens / wall:.1f} tok/s incl. prefill+capture); "
          f"latency p50={p50 * 1e3:.0f}ms p95={p95 * 1e3:.0f}ms")
    if continuous and args.dump_trace:
        # measured-vs-simulated timeline of the decode graph
        print(engine._decode_exe.render_trace(fmt=args.dump_trace))
    print("  " + " ".join(f"{k}={v}" for k, v in engine.stats().items()))
    if continuous:
        engine.close()
        runtime.close()
    bad = [t for r in done for t in r.output if t >= cfg.vocab_size]
    if bad:   # not an assert: the check must survive python -O
        raise SystemExit(f"emitted out-of-vocab ids: {bad[:5]}")
    for r in done[:3]:
        print(f"  req {r.request_id}: {len(r.output)} tokens, first 8 = {r.output[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
