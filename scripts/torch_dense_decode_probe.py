#!/usr/bin/env python3
"""How the dense decode kernel's (B2) device time scales with its work, on
one CUDA card.

    python3 scripts/torch_dense_decode_probe.py

Runs ``decode_attention_cuda`` at gemma-2b widths (8 query heads, 1 KV head,
hd 256, bf16) for a few batch sizes, cache lengths and kept fractions (all
entries, none, the first 64) and prints the device time per call of each
kernel name that ``torch.profiler`` records, in microseconds, beside a tiny
elementwise kernel as the floor of one launch.  A time that does not grow
with the kept entries says the kernel waits on memory latency, not bytes.
Prints the card's name and power limit first.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def per_call_us(torch, fn, iters: int = 50) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:48]] = out.get(e.name[:48], 0.0) + (e.time_range.end - e.time_range.start)
    return {k: round(v / iters, 2) for k, v in out.items()}


def main() -> None:
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    x = torch.zeros(1024, device="cuda")
    print("tiny add", per_call_us(torch, lambda: x.add_(1)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, kept in [(8, 1024, "all"), (8, 1024, "none"), (8, 32, "all"), (1, 1024, "all"),
                       (8, 4096, "all"), (8, 1024, "first64")]:
        q = torch.randn((B, 8, 256), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, 1, 256), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, S, 1, 256), generator=gen, device="cuda").bfloat16()
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
        if kept == "none":
            pos.fill_(-1)
        elif kept == "first64":
            pos[:, 64:] = -1
        qp = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        print(f"B={B} S={S} kept={kept}",
              per_call_us(torch, lambda: decode_attention_cuda(q, k, v, pos, qp, None)),
              flush=True)


if __name__ == "__main__":
    main()
