#!/usr/bin/env python3
"""Build the flash-attention prefill kernel (B3) and check it, on one CUDA card.

    python3 scripts/torch_flash_probe.py

The short first call for a new kernel, the twin of
``torch_moe_gmm_probe.py``: compiles ``flash_fwd.cu`` with ``-Xptxas -v``
(registers, shared memory and spills of every instantiation), then runs
``flash_attention_cuda`` at gemma-2b's prefill shape (8 query heads over 1
KV head of 256; S = 512 and 333, causal, with and without a 256-token
window), granite's (16 over 8 of 64), olmoe's (16 over 16 of 128), a
2048-token gemma prompt (the 64-row tile form), every other compiled
width, ragged lengths, ``q_offset`` and non-causal calls, in bf16, fp16
and f32, against its plain version, and prints per case the
path the launch took, the max abs error, whether two calls give the same
bits, and the ms per call from CUDA events around 50 calls (host launch
included) beside one ``scaled_dot_product_attention`` call and the bound.
Prints the card's name and power limit first.  ``chip_smoke.py`` takes the
device times.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


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


def keep_mask(torch, Sq, Skv, causal, window, q_offset):
    qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Skv, device="cuda")[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    return keep


def main() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_cuda, flash_attention_path,
                                                     flash_attention_plain)

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build_all(["flash_fwd"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s")
    print(built["flash_fwd"]["log"])
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    failed = 0
    # (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dtype)
    cases = [(1, 512, 512, 8, 1, 256, True, None, 0, bf16),
             (1, 512, 512, 8, 1, 256, True, 256, 0, bf16),
             (1, 333, 333, 8, 1, 256, True, None, 0, bf16),
             (1, 333, 333, 16, 8, 64, True, None, 0, bf16),
             (1, 512, 512, 16, 16, 128, True, None, 0, bf16),
             (1, 2048, 2048, 8, 1, 256, True, None, 0, bf16),
             (2, 97, 97, 4, 2, 16, True, None, 0, bf16),
             (2, 97, 97, 4, 2, 32, True, None, 0, bf16),
             (2, 40, 100, 4, 2, 256, True, 30, 60, bf16),
             (2, 70, 50, 4, 2, 128, False, None, 0, bf16),
             (1, 200, 200, 4, 1, 128, True, None, 0, f16),
             (1, 333, 333, 8, 1, 256, True, None, 0, f32),
             (2, 70, 50, 4, 2, 16, False, None, 0, f32)]
    for B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dt in cases:
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dt)
        tag = (f"B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} hd={hd} causal={causal} "
               f"window={window} q_offset={q_offset} {str(dt)[6:]}")
        try:
            out = flash_attention_cuda(q, k, v, causal, window, q_offset)
            torch.cuda.synchronize()
        except Exception as exc:            # report every case, then fail
            print(f"{tag}: FAILED {exc}", flush=True)
            failed += 1
            continue
        ref = flash_attention_plain(q, k, v, causal, window, q_offset)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-5 if dt == f32 else 3e-2
        same = torch.equal(out, flash_attention_cuda(q, k, v, causal, window, q_offset))
        ok = err <= tol and same and bool(torch.isfinite(out).all())
        failed += not ok
        ms = event_ms(torch, lambda: flash_attention_cuda(q, k, v, causal, window, q_offset))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kt, vt = kt.repeat_interleave(Hq // Hkv, 1), vt.repeat_interleave(Hq // Hkv, 1)
        mask = keep_mask(torch, Sq, Skv, causal, window, q_offset)
        sdpa_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         attn_mask=mask))
        pairs = int(mask.sum())
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 4.0 * B * pairs * Hq * hd / BF16_FLOPS)
        print(f"{tag}: path={flash_attention_path(dt)} err={err:.3e} repeat_equal={same} "
              f"{'ok' if ok else 'WRONG'} ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} "
              f"bound_ms={bound:.5f}", flush=True)
    if failed:
        sys.exit(f"{failed} case(s) failed")


if __name__ == "__main__":
    main()
