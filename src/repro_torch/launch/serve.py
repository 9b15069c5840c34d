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

``--arch`` takes every ported config: gemma-2b, the MoE archs
(granite-moe-1b-a400m, olmoe-1b-7b), falcon-mamba-7b and recurrentgemma-2b;
``--paged`` refuses the last two, whose recurrent state has no paged cache,
with the reference's message.

Not ported yet, and refused with the ROADMAP item that brings them:
``--replicas > 1`` (the serving fleet, A14), ``--check`` other than
``off`` (the hazard checks, A12) and ``--pinning`` other than ``off``
(core pinning, A13).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models import transformer
from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig, ServeEngine
from repro_torch.serve.paged import PagedConfig, PagedEngine, refuse_unpaged

_NOT_PORTED = {
    "replicas": "--replicas > 1 needs the serving fleet, not ported yet (ROADMAP A14)",
    "check": "--check needs the hazard checks, not ported yet (ROADMAP A12)",
    "pinning": "--pinning needs the hwperf layer, not ported yet (ROADMAP A13)",
}


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


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True)
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
                   help="executor-thread core pinning (only 'off' is ported)")
    p.add_argument("--dump-trace", choices=("ascii", "csv"), default=None,
                   help="print the decode executable's last execution timeline "
                        "(measured if available, else simulated) after serving "
                        "(continuous/paged only)")
    p.add_argument("--schedule-search", choices=("off", "auto", "force"), default="auto",
                   help="simulator-guided schedule search over registered policies: "
                        "'auto' (default) once the decode graph is calibrated, 'force' "
                        "always, 'off' plain CPF (continuous/paged only)")
    p.add_argument("--check", choices=("off", "basic", "strict"), default="off",
                   help="static verification of the engine's graphs (not ported)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a multi-replica fleet (not ported)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    refused = [msg for key, msg in _NOT_PORTED.items()
               if (args.replicas > 1 if key == "replicas" else getattr(args, key) != "off")]
    if refused:
        raise SystemExit("; ".join(refused))

    from repro_torch.device import resolve_device
    from repro_torch.runtime import Runtime, set_default_runtime

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.paged:
        try:                  # before building the weights: the arch has no paged cache
            refuse_unpaged(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    params = transformer.init_params(cfg, 0, device=dev)
    prompt_lens = [int(x) for x in str(args.prompt_len).split(",")]
    scfg = ServeConfig(max_batch=args.max_batch, max_len=max(prompt_lens) + args.max_new + 1,
                       temperature=args.temperature)
    continuous = args.continuous or args.paged
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
