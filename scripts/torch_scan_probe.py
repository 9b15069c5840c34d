#!/usr/bin/env python3
"""Build the two recurrent-scan kernels (B6 selective scan, B7 RG-LRU scan)
and check them, on one CUDA card.

    python3 scripts/torch_scan_probe.py

The short first call after a change to either kernel: compiles
``ssm_scan.cu`` and ``rglru_scan.cu`` with ``-Xptxas -v`` (registers,
shared memory and spills of every instantiation), then runs each wrapper
at falcon-mamba-7b's and recurrentgemma-2b's serving shapes (prefill of a
333-token prompt, a decode step of 8 slots) and at ragged ones, against
its plain version, and prints per case the max abs error, whether the
state matches the plain version bit for bit, whether two calls give the
same bits, and the ms per call from CUDA events around 20 calls (host
launch included) beside the bytes-over-3.35-TB/s bound.  Prints the
card's name and power limit first.  ``chip_smoke.py`` takes the device
times.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HBM_BYTES_PER_S = 3.35e12


def event_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ssm_inputs(torch, gen, B, S, D, St, c_dtype, h0):
    """The model's distributions: a = exp(-dt·A) with dt in [0.001, 0.1]
    and A = 1..St, b = dt·B·x, c and x standard normal."""
    dt = torch.rand((B, S, D, 1), generator=gen, device="cuda") * 0.099 + 0.001
    A = torch.arange(1, St + 1, dtype=torch.float32, device="cuda")
    a = torch.exp(-dt * A)
    b = dt * torch.randn((B, S, 1, St), generator=gen, device="cuda") \
        * torch.randn((B, S, D, 1), generator=gen, device="cuda")
    c = torch.randn((B, S, St), generator=gen, device="cuda").to(c_dtype)
    h = torch.randn((B, D, St), generator=gen, device="cuda") if h0 else None
    return a, b, c, h


def rglru_inputs(torch, gen, B, S, R, h0):
    """The model's distributions: a = exp(-8·softplus(Λ)·r) with Λ over
    recurrentgemma's init range and r in (0, 1), b = sqrt(1 - a²)·N(0, 1)."""
    lam = torch.log(torch.expm1(torch.linspace(0.3, 1.3, R, device="cuda")))
    r = torch.rand((B, S, R), generator=gen, device="cuda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    b = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * torch.randn((B, S, R), generator=gen,
                                                                      device="cuda")
    h = torch.randn((B, R), generator=gen, device="cuda") if h0 else None
    return a, b, h


def main() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build_all(["ssm_scan", "rglru_scan"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s")
    for name, b in built.items():
        print(name, b["log"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    for B, S, D, St, cdt, h0 in ((1, 333, 8192, 16, bf16, False), (1, 333, 8192, 16, f32, False),
                                (8, 1, 8192, 16, bf16, True), (2, 37, 200, 16, f32, True),
                                (1, 200, 8192, 16, bf16, False), (3, 9, 7, 5, f32, True),
                                (2, 20, 33, 32, f32, True), (1, 3, 5, 1, f32, False)):
        a, b, c, h = ssm_inputs(torch, gen, B, S, D, St, cdt, h0)
        y, hl = ssm_scan_cuda(a, b, c, h)
        ry, rh = ssm_scan_plain(a, b, c, h)
        torch.cuda.synchronize()
        err = max((y - ry).abs().max().item(), (hl - rh).abs().max().item())
        y2, h2 = ssm_scan_cuda(a, b, c, h)
        same = torch.equal(y, y2) and torch.equal(hl, h2)
        ms = event_ms(torch, lambda: ssm_scan_cuda(a, b, c, h))
        nbytes = (a.numel() + b.numel() + y.numel() + hl.numel()) * 4 + c.numel() * \
            c.element_size() + (0 if h is None else h.numel() * 4)
        print(f"ssm_scan B={B} S={S} D={D} St={St} c={cdt} h0={h0}: err={err:.3e} "
              f"h_bit_equal={torch.equal(hl, rh)} repeat_equal={same} ms={ms:.4f} "
              f"bound_ms={1e3 * nbytes / HBM_BYTES_PER_S:.4f} |y|max={y.abs().max().item():.2f}",
              flush=True)
    for B, S, R, h0 in ((1, 333, 2560, False), (8, 1, 2560, True), (2, 37, 200, True),
                        (4, 200, 2560, False), (1, 5, 1, True)):
        a, b, h = rglru_inputs(torch, gen, B, S, R, h0)
        hs, hl = rglru_scan_cuda(a, b, h)
        rhs, rh = rglru_scan_plain(a, b, h)
        torch.cuda.synchronize()
        err = max((hs - rhs).abs().max().item(), (hl - rh).abs().max().item())
        same = torch.equal(hs, rglru_scan_cuda(a, b, h)[0])
        ms = event_ms(torch, lambda: rglru_scan_cuda(a, b, h))
        nbytes = (a.numel() + b.numel() + hs.numel() + hl.numel()
                  + (0 if h is None else h.numel())) * 4
        print(f"rglru_scan B={B} S={S} R={R} h0={h0}: err={err:.3e} "
              f"bit_equal={torch.equal(hs, rhs) and torch.equal(hl, rh)} repeat_equal={same} "
              f"ms={ms:.4f} bound_ms={1e3 * nbytes / HBM_BYTES_PER_S:.4f}", flush=True)


if __name__ == "__main__":
    main()
