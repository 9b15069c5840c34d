#!/usr/bin/env python3
"""Build the two recurrent-scan kernels (B6 selective scan, B7 RG-LRU scan)
and the LSTM cell (B4), and check them, on one CUDA card.

    python3 scripts/torch_scan_probe.py

The short first call after a change to any of them: compiles
``ssm_scan.cu``, ``rglru_scan.cu`` and ``lstm_cell.cu`` with ``-Xptxas
-v`` and prints each instantiation's registers, static shared memory and
spills (B7's ring is dynamic: its bytes are printed per case).
Then runs each scan at falcon-mamba-7b's and recurrentgemma-2b's serving
shapes (prefill of a 333-token prompt, B7 also the wave engine's B = 4 and
a 2048-token prompt, a decode step of 8 slots) and at ragged ones, against
its plain version, and prints per case the max abs error, whether the
state (B7: every output) matches the plain version bit for bit, whether
two calls give the same bits, the ms per call from CUDA events around 20
calls (host launch included) and, for B7, the device µs per call from
``torch.profiler``, beside the bytes-over-3.35-TB/s bound and the tiling
``scan_tiles`` picks.  Then B4 at the LSTM's shapes (N = 64 and 256 rows
of H = 1024, f32 and bf16 gates, a ragged 37 x 200): max abs error against
the plain version, two calls equal, device µs of the kernel beside
``aten._thnn_fused_lstm_cell``'s and the bound, and device µs of every
grid the kernel takes (columns a thread x threads a CTA), the evidence
behind ``cell_tiles``.  Prints the card's name and power limit first.
``chip_smoke.py`` takes the device times of record.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

HBM_BYTES_PER_S = 3.35e12


def ptxas_rows(log: str) -> list[str]:
    """One line per compiled kernel: its name (demangled where the toolkit's
    ``cu++filt`` is at hand), registers, shared memory and spills, from
    ``-Xptxas -v``."""
    import shutil

    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    rows, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            if filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            rows.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return rows


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

    from torch_dense_decode_probe import per_call_us

    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain, scan_tiles
    from repro_torch.kernels.rglru_scan.ops import ring_bytes
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build_all(["ssm_scan", "rglru_scan", "lstm_cell"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s")
    for name, b in built.items():
        for row in ptxas_rows(b["log"]):
            print(f"ptxas {name}: {row}")
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
    for B, S, R, h0 in ((1, 333, 2560, False), (4, 333, 2560, False), (1, 2048, 2560, False),
                        (8, 1, 2560, True), (2, 37, 200, True), (4, 200, 2560, False),
                        (1, 5, 1, True), (3, 101, 1030, True)):
        a, b, h = rglru_inputs(torch, gen, B, S, R, h0)
        hs, hl = rglru_scan_cuda(a, b, h)
        rhs, rh = rglru_scan_plain(a, b, h)
        torch.cuda.synchronize()
        err = max((hs - rhs).abs().max().item(), (hl - rh).abs().max().item())
        same = torch.equal(hs, rglru_scan_cuda(a, b, h)[0])
        ms = event_ms(torch, lambda: rglru_scan_cuda(a, b, h))
        nbytes = (a.numel() + b.numel() + hs.numel() + hl.numel()
                  + (0 if h is None else h.numel())) * 4
        us = sum(per_call_us(torch, lambda: rglru_scan_cuda(a, b, h)).values())
        tiles = scan_tiles(B, S, R)
        smem = ring_bytes(*tiles) if tiles.channels else 0
        print(f"rglru_scan B={B} S={S} R={R} h0={h0} tiles={tuple(tiles)} "
              f"dynamic_smem={smem}: "
              f"err={err:.3e} bit_equal={torch.equal(hs, rhs) and torch.equal(hl, rh)} "
              f"repeat_equal={same} ms={ms:.4f} device_us={us:.2f} "
              f"bound_ms={1e3 * nbytes / HBM_BYTES_PER_S:.5f}", flush=True)
    lstm_cells(torch, per_call_us)


def lstm_cells(torch, per_call_us) -> None:
    """B4 against its plain version and aten._thnn_fused_lstm_cell, and
    every grid the kernel takes."""
    from repro_torch.kernels.lstm_cell import ops

    f32, bf16 = torch.float32, torch.bfloat16
    codes = {f32: 0, bf16: 1}
    for N, H, gdt in ((64, 1024, f32), (256, 1024, f32), (64, 1024, bf16), (37, 200, f32)):
        gen = torch.Generator(device="cuda").manual_seed(N + H)
        gx, gh = (torch.randn((N, 4 * H), generator=gen, device="cuda").to(gdt)
                  for _ in range(2))
        b = torch.randn((4 * H,), generator=gen, device="cuda").to(gdt)
        c = torch.randn((N, H), generator=gen, device="cuda")
        h, cn = ops.lstm_cell_cuda(gx, gh, b, c)
        rh, rc = ops.lstm_cell_plain(gx, gh, b, c)
        torch.cuda.synchronize()
        err = max((h.float() - rh.float()).abs().max().item(), (cn - rc).abs().max().item())
        h2, c2 = ops.lstm_cell_cuda(gx, gh, b, c)
        same = torch.equal(h, h2) and torch.equal(cn, c2)
        us = sum(per_call_us(torch, lambda: ops.lstm_cell_cuda(gx, gh, b, c), 200).values())
        # thnn's forget gate has no +1: its bias carries it (chip_smoke's yardstick)
        bs = b.clone()
        bs[H:2 * H] += 1
        cs, zero = c.to(gdt), torch.zeros_like(bs)
        lib = sum(per_call_us(torch, lambda: torch.ops.aten._thnn_fused_lstm_cell(
            gx, gh, cs, bs, zero), 200).values())
        nbytes = (2 * gx.numel() + b.numel() + N * H) * gx.element_size() + 2 * c.numel() * 4
        fn = ops._lib().lstm_cell_fwd
        grids = {}
        for cols in (4, 2, 1):
            for threads in (64, 128, 256):
                def call(cols=cols, threads=threads):
                    err = fn(gx.data_ptr(), gh.data_ptr(), b.data_ptr(), c.data_ptr(),
                             h.data_ptr(), cn.data_ptr(), codes[gdt], 0, N, H, cols, threads,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"lstm_cell launch failed: CUDA error {err}")
                grids[f"{cols}x{threads}"] = round(sum(per_call_us(torch, call, 200).values()), 2)
        print(f"lstm_cell N={N} H={H} gates={gdt} "
              f"tiles={tuple(ops.cell_tiles(N, H, gx.element_size()))}: "
              f"err={err:.3e} repeat_equal={same} device_us={us:.2f} thnn_us={lib:.2f} "
              f"bound_us={1e6 * nbytes / HBM_BYTES_PER_S:.2f} grids (cols x threads -> us): "
              f"{grids}", flush=True)


if __name__ == "__main__":
    main()
