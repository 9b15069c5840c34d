"""One traced run of a serving mix on the paged engine, for the device's idle
share: a finding for a later serving cell, not a cell.

    python bench/probe_serving.py --seed <n> [--seconds 30] [--rate 1.0]

command-r-plus-104b cut to 4 of its 64 layers (~25 GB of weights; the cut
layers would lie on further cards; at 8 layers a 512-token chunk against an
8k-token context ran out of memory, since the runtime keeps every node's
result, each chunk's f32 scores 1.6 GB a layer), prefill chunks of 256
tokens, on ``repro_torch.serve_engine(..., paged=...)``: documents of 2k-8k
tokens, each asked 3-5 times (the document, then a 16-token question),
32-128 tokens out, arriving open-loop at ``--rate`` requests a second
(Poisson, from the seed).  Prefix sharing
and chunked prefill do the work.  ``torch.profiler`` records the device
alone over the serving window; the line printed gives the union of the
device intervals over the wall, with the requests finished and their
tokens.  The weights are the program's own random ones
(``transformer.init_params``): nothing here is checked for correctness.
"""
import argparse
import json
import sys
import time


def requests(seed: int, vocab: int, n_docs: int, seconds: float, rate: float):
    """``[(arrival_s, prompt, max_new_tokens)]`` sorted by arrival."""
    import numpy as np

    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=int(rng.integers(2048, 8193)), dtype=np.int32)
            for _ in range(n_docs)]
    asks = [d for d in docs for _ in range(int(rng.integers(3, 6)))]
    rng.shuffle(asks)
    t, out = 0.0, []
    for doc in asks:
        t += float(rng.exponential(1.0 / rate))
        if t > seconds:
            break
        question = rng.integers(0, vocab, size=16, dtype=np.int32)
        out.append((t, np.concatenate([doc, question]), int(rng.integers(32, 129))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--smoke", action="store_true", help="the smoke config on the CPU")
    args = ap.parse_args(argv)

    from harness import paths

    root = paths.setup()
    import torch

    import repro_torch
    from harness import tracing
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, Request, ServeConfig

    device = "cpu" if args.smoke else "cuda"
    cfg = get_config("command-r-plus-104b", smoke=args.smoke)
    if not args.smoke:
        cfg = cfg.reduced(n_layers=args.layers)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, args.seed, device=device)
    rt = Runtime(device=device)
    max_len = 8192 + 16 + 128 if not args.smoke else 256
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=max_len),
                                   paged=PagedConfig(page_size=16, prefill_chunk=256),
                                   device=device, runtime=rt)
    setup_s = time.perf_counter() - t0
    todo = requests(args.seed, cfg.vocab_size, 4, args.seconds, args.rate)
    if args.smoke:
        todo = [(t, p[: 64 + i], n % 16 + 1) for i, (t, p, n) in enumerate(todo)]
    done = []

    def serve(_):
        start = time.perf_counter()
        nxt = 0
        while nxt < len(todo) or eng.has_work:
            now = time.perf_counter() - start
            while nxt < len(todo) and todo[nxt][0] <= now:
                _, prompt, n_new = todo[nxt]
                eng.submit(Request(nxt, prompt, max_new_tokens=n_new))
                nxt += 1
            if eng.has_work:
                eng.step()
                done.extend(eng.completed)
                eng.completed = []
            else:
                time.sleep(0.001)
        if device == "cuda":
            torch.cuda.synchronize()

    try:
        if device == "cuda":
            tr = tracing.profile(serve, 1, root / "build" / "bench" / "probe_serving.trace.json",
                                 host=False)
            busy = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                    "device_idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
                    "device_ops": tr.breakdown()["device_ops"][:5]}
        else:
            t1 = time.perf_counter()
            serve(1)
            busy = {"window_s": time.perf_counter() - t1}
    finally:
        rt.close()
    print(json.dumps({"seed": args.seed, "layers": cfg.n_layers, "rate": args.rate,
                      "setup_s": setup_s, "requests": len(todo), "finished": len(done),
                      "tokens_out": sum(len(r.output) for r in done), **busy,
                      "engine": eng.stats(),
                      "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
