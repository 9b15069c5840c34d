#!/usr/bin/env python3
"""Build the grouped expert matmul kernel (B5) and check it, on one CUDA card.

    python3 scripts/torch_moe_gmm_probe.py

The short first call for a new kernel: compiles ``moe_gmm.cu`` with
``-Xptxas -v`` (registers, shared memory and spills of every instantiation),
then runs ``moe_gmm_cuda`` at granite-moe-1b-a400m's expert shapes (E = 32,
D x F = 1024 x 512 and 512 x 1024, C = 8 .. 416), in f32 and at ragged
shapes, against its plain version, and prints per case the kernel form
(``mma`` or ``simt``), the max abs error,
whether two calls give the same bits, and the ms per call from CUDA events
around 50 calls (host launch included, weights warm in L2) beside
``torch.bmm`` and the bytes-over-3.35-TB/s bound.  Prints the card's name
and power limit first.  ``chip_smoke.py`` takes the device times.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HBM_BYTES_PER_S = 3.35e12


def event_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_path, moe_gmm_plain

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build_all(["moe_gmm"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s")
    print(built["moe_gmm"]["log"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    for E, C, D, F, dt in ((32, 8, 1024, 512, bf16), (32, 8, 512, 1024, bf16),
                           (32, 40, 1024, 512, bf16), (32, 104, 1024, 512, bf16),
                           (32, 256, 1024, 512, bf16), (32, 416, 1024, 512, bf16),
                           (32, 104, 1024, 512, f32), (3, 37, 200, 72, bf16),
                           (3, 5, 200, 72, bf16), (3, 13, 136, 200, bf16),
                           (3, 29, 136, 72, bf16), (3, 100, 200, 72, bf16),
                           (3, 37, 200, 72, f32), (3, 37, 201, 73, f32), (2, 1, 5, 3, bf16)):
        x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
        w = (torch.randn((E, D, F), generator=gen, device="cuda") * D ** -0.5).to(dt)
        out = moe_gmm_cuda(x, w)
        err = (out.float() - moe_gmm_plain(x, w).float()).abs().max().item()
        same = torch.equal(out, moe_gmm_cuda(x, w))
        ms = event_ms(torch, lambda: moe_gmm_cuda(x, w))
        bmm_ms = event_ms(torch, lambda: torch.bmm(x, w))
        nbytes = (x.numel() + w.numel() + E * C * F) * x.element_size()
        print(f"E={E} C={C} D={D} F={F} {dt}: path={moe_gmm_path(x, w)} err={err:.3e} "
              f"repeat_equal={same} ms={ms:.4f} "
              f"bmm_ms={bmm_ms:.4f} bound_ms={1e3 * nbytes / HBM_BYTES_PER_S:.4f}", flush=True)


if __name__ == "__main__":
    main()
