"""Batched serving demo on the PyTorch port: the wave-batching engine over
a reduced gemma config (``--arch`` for another ported config), on the card
(``--device cpu`` for the CPU).  The twin of ``examples/serve_decode.py``.

Submits a mixed bag of requests (different prompt lengths and budgets),
serves them in waves, and reports decode throughput.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] [--arch command-r-plus-104b]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--arch", default="gemma-2b")
    p.add_argument("--requests", type=int, default=10)
    args = p.parse_args(argv)
    cfg = get_config(args.arch, smoke=True)
    params = transformer.init_params(cfg, 7, device=args.device)
    engine = ServeEngine(cfg, params, ServeConfig(max_batch=4, max_len=128, temperature=0.8),
                         device=args.device)
    rng = np.random.default_rng(1)
    for i in range(args.requests):
        plen = int(rng.integers(8, 48))
        engine.submit(Request(
            request_id=i,
            prompt=rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 32)),
            eos_id=None,
        ))
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    print(f"{cfg.name} on {args.device}: {len(done)} requests -> {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    for r in done:
        print(f"  req {r.request_id:2d}: prompt {len(r.prompt):3d} tok, "
              f"generated {len(r.output):3d}, head={r.output[:6]}")
    return done


if __name__ == "__main__":
    main()
