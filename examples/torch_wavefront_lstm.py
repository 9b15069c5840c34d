"""The flagship scheduling demo (paper §7.4) on the PyTorch port: critical-path-
first scheduling recovers cuDNN's hand-crafted diagonal-wavefront LSTM
schedule.  The recovered schedule is then run as real compute three ways —
the stacked static plan (one batched cell per anti-diagonal), the sequential
interpreter, and the sequential LSTM captured into a graph of L×T cells and
run by ``repro_torch.compile`` on the runtime's executors — and the three
are held to each other.  The cell update is kernel B4 (``kernels/lstm_cell``)
on the card, its plain version on the CPU.

    PYTHONPATH=src python examples/torch_wavefront_lstm.py               # on the card
    PYTHONPATH=src python examples/torch_wavefront_lstm.py --device cpu  # anywhere

Times are host wall clock around calls that end in a device synchronise;
they describe the device the run used and nothing else.
"""
import argparse
import statistics
import time

import torch

import repro_torch
from repro_torch.core.cost_model import H100
from repro_torch.core.trace import ascii_timeline
from repro_torch.core.wavefront import (diagonals, is_wavefront_order, recurrence_graph,
                                        sequential_lstm, stacked_wavefront_lstm)
from repro_torch.device import resolve_device
from repro_torch.runtime import Runtime

L, T, B, H = 4, 12, 16, 128


def _wall_ms(fn, dev: torch.device, iters: int = 10) -> float:
    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with Runtime(device=dev) as rt:
        flops = 2 * 2 * B * H * 4 * H
        g = recurrence_graph(L, T, flops_per_cell=flops, bytes_per_cell=3 * B * H * 4)
        print(f"recurrence DAG: {L} layers x {T} steps, width={g.width()}")
        exe = repro_torch.compile(g, hw=H100, backend="sim", n_workers=L, reserved_workers=0,
                                  runtime=rt)
        exe.profile_with(extra_configs=[(L, 1)])
        sched = exe.schedule
        ok = is_wavefront_order(sched.start_order(), g)
        print(f"CPF start order follows anti-diagonals: {ok}")
        print(f"reference diagonals: {[len(d) for d in diagonals(L, T)]} cells/wave")
        print(ascii_timeline(
            [type("E", (), {"op": n, "executor": e, "start": s, "end": t})()
             for n, (e, s, t) in sched.placements.items()],
            sched.n_executors, width=76,
        ))

        # the same plan as real compute: stacked diagonal cells vs the loop
        gen = torch.Generator(device=dev).manual_seed(0)
        stacked = {k: torch.randn(shape, generator=gen, device=dev) * 0.05
                   for k, shape in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)),
                                    ("b", (L, 4 * H)))}
        xs = torch.randn((T, B, H), generator=gen, device=dev)
        per_layer = [{k: v[i].contiguous() for k, v in stacked.items()} for i in range(L)]
        ref = sequential_lstm(per_layer, xs)
        out = stacked_wavefront_lstm(stacked, xs, L)
        print(f"stacked wavefront == sequential: max err {(out - ref).abs().max().item():.2e}")

        # and through Graphi's runtime: the L×T cell graph on executors
        lstm = repro_torch.compile(sequential_lstm, per_layer, xs, hw=H100, runtime=rt,
                                   jit_nodes=True, host_mode="static")
        got = lstm(per_layer, xs)
        n_cells = sum(1 for n in lstm.graph.nodes if n.kind == "lstm_cell")
        print(f"runtime: {len(lstm.graph)} nodes ({n_cells} lstm_cell), "
              f"static plan on {lstm.host_plan().n_executors} executors; "
              f"== sequential: max err {(got - ref).abs().max().item():.2e}")

        for name, fn in (("sequential", lambda: sequential_lstm(per_layer, xs)),
                         ("wavefront", lambda: stacked_wavefront_lstm(stacked, xs, L)),
                         ("runtime", lambda: lstm(per_layer, xs))):
            print(f"{name:11s}: {_wall_ms(fn, dev):7.2f} ms/forward "
                  f"[host wall p50 on {dev}]")


if __name__ == "__main__":
    main()
