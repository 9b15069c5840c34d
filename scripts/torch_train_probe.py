#!/usr/bin/env python3
"""Build the training kernels and check them, on one CUDA card.

    python3 scripts/torch_train_probe.py

The short first call after a change to a backward kernel: compiles
``flash_fwd.cu`` (B3, whose training form also writes each row's
log-sum-exp), ``flash_bwd.cu`` (B3's backward) and ``lstm_cell.cu`` (B4 and
its backward) with ``-Xptxas -v`` (registers, shared memory and spills of
every instantiation), then runs

* the training forward at gemma-2b's shape and others: its output must be
  the serving kernel's bit for bit, its log-sum-exp within the tolerance of
  the plain version's;
* ``flash_attention_bwd_cuda`` against ``flash_attention_bwd_plain`` at
  gemma-2b's training shape (B = 4, S = 512, 8 / 1 heads of 256, bf16),
  with a 256-token window, in f32 and fp16, at granite's (16 / 8 heads of
  64) and olmoe's (16 of 128) widths, ragged lengths, ``q_offset`` and a
  non-causal call, every element compared, and twice for the same bits;
* ``lstm_cell_bwd_cuda`` against ``lstm_cell_bwd_plain`` (N = 64 and 256,
  H = 1024; bf16 gates with f32 state; a ragged N = 37, H = 200);
* autograd through both training ops on the card against the CPU.

Prints per case the max abs error and the ms per call from CUDA events
around 20 calls (host launch included) beside the plain version and one
PyTorch library call (SDPA forward + backward; ``aten.
_thnn_fused_lstm_cell_backward_impl``).  Prints the card's name and power
limit first; exits non-zero if any case is wrong.  ``chip_smoke.py`` takes
the device times.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def event_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
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
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_attention_train,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.flash_attention.ops import _keep, _plain_forward
    from repro_torch.kernels.lstm_cell import (lstm_cell_bwd_cuda, lstm_cell_bwd_plain,
                                               lstm_cell_fused)

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    built = _build.build_all(["flash_fwd", "flash_bwd", "lstm_cell"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s")
    for name, b in built.items():
        lines = [ln.strip() for ln in b["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"--- {name}\n" + "\n".join(lines))
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    tol = {f32: 2e-5, bf16: 3e-2, f16: 3e-2}
    failed = 0

    def report(tag, err, limit, same, extra=""):
        nonlocal failed
        ok = err <= limit and same
        failed += not ok
        print(f"{tag}: err={err:.3e} (limit {limit}) repeat_equal={same} "
              f"{'ok' if ok else 'WRONG'} {extra}", flush=True)

    # (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dtype)
    cases = [(4, 512, 512, 8, 1, 256, True, None, 0, bf16),
             (4, 512, 512, 8, 1, 256, True, 256, 0, bf16),
             (1, 333, 333, 8, 1, 256, True, None, 0, f32),
             (1, 200, 200, 4, 1, 128, True, None, 0, f16),
             (2, 333, 333, 16, 8, 64, True, None, 0, bf16),
             (1, 512, 512, 16, 16, 128, True, None, 0, bf16),
             (2, 97, 97, 4, 2, 16, True, None, 0, bf16),
             (2, 97, 97, 4, 1, 32, True, 9, 0, f32),
             (2, 40, 100, 4, 2, 256, True, 30, 60, bf16),
             (2, 70, 50, 4, 2, 128, False, None, 0, f32)]
    for B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset, dt in cases:
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dt)
        do = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").to(dt)
        tag = (f"B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} hd={hd} causal={causal} "
               f"window={window} q_offset={q_offset} {str(dt)[6:]}")
        try:
            out, lse = flash_attention_train_cuda(q, k, v, causal, window, q_offset)
            dq, dk, dv = flash_attention_bwd_cuda(do, q, k, v, out, lse, causal, window,
                                                  q_offset)
            torch.cuda.synchronize()
        except Exception as exc:            # report every case, then fail
            print(f"{tag}: FAILED {exc}", flush=True)
            failed += 1
            continue
        same_out = torch.equal(out, flash_attention_cuda(q, k, v, causal, window, q_offset))
        _, lse_ref = _plain_forward(q, k, v, causal, window, q_offset, 1024, 512)
        lse_err = (lse - lse_ref).abs().max().item()
        report(f"fwd+lse {tag}", lse_err, tol[dt], same_out, "(out equal to the serving call)")
        ref = flash_attention_bwd_plain(do, q, k, v, out, lse, causal, window, q_offset)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip((dq, dk, dv), ref))
        again = flash_attention_bwd_cuda(do, q, k, v, out, lse, causal, window, q_offset)
        same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        ms = event_ms(torch, lambda: flash_attention_bwd_cuda(do, q, k, v, out, lse, causal,
                                                              window, q_offset))
        fwd_ms = event_ms(torch, lambda: flash_attention_train_cuda(q, k, v, causal, window,
                                                                    q_offset))
        plain_ms = event_ms(torch, lambda: flash_attention_bwd_plain(
            do, q, k, v, out, lse, causal, window, q_offset), 3)
        qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        mask = _keep(Sq, Skv, causal, window, q_offset, "cuda")

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=Hq != Hkv)
            torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))
        try:
            sdpa_ms = f"{event_ms(torch, sdpa):.4f}"
        except RuntimeError as exc:         # a yardstick only
            sdpa_ms = f"n/a ({str(exc)[:60]})"
        report(f"bwd {tag}", err, tol[dt], same and finite,
               f"bwd_ms={ms:.4f} train_fwd_ms={fwd_ms:.4f} plain_bwd_ms={plain_ms:.4f} "
               f"sdpa_fwd_bwd_ms={sdpa_ms}")

    for N, H, gates, state in ((64, 1024, f32, f32), (256, 1024, f32, f32),
                               (64, 1024, bf16, f32), (37, 200, f32, f32),
                               (16, 64, bf16, bf16)):
        gx, gh = (torch.randn((N, 4 * H), generator=gen, device="cuda").to(gates)
                  for _ in range(2))
        b = torch.randn((4 * H,), generator=gen, device="cuda").to(gates)
        c = torch.randn((N, H), generator=gen, device="cuda").to(state)
        dh = torch.randn((N, H), generator=gen, device="cuda").to(gates)
        dc = torch.randn((N, H), generator=gen, device="cuda").to(state)
        tag = f"lstm_cell_bwd N={N} H={H} {str(gates)[6:]}/{str(state)[6:]}"
        try:
            dg, dcp = lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc)
            torch.cuda.synchronize()
        except Exception as exc:
            print(f"{tag}: FAILED {exc}", flush=True)
            failed += 1
            continue
        rg, rc = lstm_cell_bwd_plain(gx, gh, b, c, dh, dc)
        err = max((dg.float() - rg.float()).abs().max().item(),
                  (dcp.float() - rc.float()).abs().max().item())
        again = lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc)
        same = torch.equal(again[0], dg) and torch.equal(again[1], dcp)
        ms = event_ms(torch, lambda: lstm_cell_bwd_cuda(gx, gh, b, c, dh, dc), 100)
        plain_ms = event_ms(torch, lambda: lstm_cell_bwd_plain(gx, gh, b, c, dh, dc), 20)
        report(tag, err, tol[bf16] if bf16 in (gates, state) else tol[f32], same,
               f"ms={ms:.5f} plain_ms={plain_ms:.5f}")

    # autograd through both training ops, card against the CPU (f32)
    q = torch.randn((2, 64, 4, 32), generator=gen, device="cuda")
    k, v = (torch.randn((2, 64, 2, 32), generator=gen, device="cuda") for _ in range(2))
    do = torch.randn((2, 64, 4, 32), generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        ins = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_train(*ins, causal=True, window=20, chunk=16, q_chunk=32)
        grads[dev] = torch.autograd.grad(o, ins, do.to(dev))
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(grads["cuda"], grads["cpu"]))
    report("autograd flash_attention_train card vs cpu", err, 2e-5, True)
    gx, gh = (torch.randn((8, 256), generator=gen, device="cuda") for _ in range(2))
    b, c = torch.randn((256,), generator=gen, device="cuda"), torch.randn((8, 64),
                                                                          generator=gen,
                                                                          device="cuda")
    for dev in ("cuda", "cpu"):
        ins = [t.to(dev).requires_grad_(True) for t in (gx, gh, b, c)]
        h, cn = lstm_cell_fused(*ins)
        grads[dev] = torch.autograd.grad((h * h).sum() + cn.sum(), ins)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(grads["cuda"], grads["cpu"]))
    report("autograd lstm_cell card vs cpu", err, 2e-5, True)
    if failed:
        sys.exit(f"{failed} case(s) failed")


if __name__ == "__main__":
    main()
