#!/usr/bin/env python3
"""Build the flash-attention prefill kernel (B3) and check it, on one CUDA card.

    python3 scripts/torch_flash_probe.py [--baseline FLASH_FWD_CU ...] [--plant]

The short first call for a new kernel, the twin of
``torch_moe_gmm_probe.py``: compiles ``flash_fwd.cu`` with ``-Xptxas -v``
(registers, shared memory and spills of every instantiation), then runs
``flash_attention_cuda`` at gemma-2b's prefill shape (8 query heads over 1
KV head of 256; S = 512 and 333, causal, with and without a 256-token
window), granite's (16 over 8 of 64), olmoe's (16 over 16 of 128), a
2048-token gemma prompt (the 64-row tile form), every other compiled
width, h2o-danube3-4b's 32 / 8 heads of 120 (padded to 128) and other head
dims between the compiled widths (72, 200 on the tensor cores; 7, 60, 100
on the CUDA cores), ragged lengths, ``q_offset`` and non-causal calls, in bf16, fp16
and f32, against its plain version, and prints per case the
path the launch took, the max abs error, whether two calls give the same
bits, and the ms per call from CUDA events around 50 calls (host launch
included) beside one ``scaled_dot_product_attention`` call and the bound.
With ``--baseline`` (given once or more), also builds each such copy of
``flash_fwd.cu`` (an earlier version with the same C entry point) and times
it against this one in turns (baseline, this, this, baseline; device ms
from ``torch.profiler``): the serving form at the prefill shapes of
gemma-2b (8 / 1 heads of 256, causal, and with a 256-token window),
granite-moe-1b-a400m (16 / 8 of 64), olmoe-1b-7b (16 / 16 of 128) and
h2o-danube3-4b (32 / 8 of 120), B = 1, S = 512, and the training form
(with the log-sum-exp) at their training shapes, B = 4; a shape the copy
refuses reads n/a.  Prints the card's name and power limit first.
``chip_smoke.py`` takes the device times.

With ``--plant``, also holds chip_smoke's bar for B3's bf16 frontend rows
(``check_near_exact``: within ``BF16_ULPS`` bf16 ulps of each row's largest
value of the plain version run in f32 on the same bf16 inputs) against a
planted fault: a copy of ``flash_fwd.cu`` whose tensor-core KV walk drops
the last key tile where the keys end inside it (whisper's 1500 keys = 23 x
64 + 28), written to a temporary directory and built beside this one.  At
chip_smoke's frontend shapes (``FRONTEND_FLASH``, its inputs) it prints
this kernel's, the bf16 plain version's and the planted copy's max abs
error and ulps against the f32 answer; it fails if this kernel misses the
bar or the planted copy meets it at a shape whose keys end inside a tile.
"""
import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

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


def baseline_fwd(torch, path: str):
    """The forward of another ``flash_fwd.cu`` (the same C entry point);
    returns a call with ``flash_attention_cuda``'s arguments and ``train``
    (write the log-sum-exp too)."""
    from torch_train_probe import build_baseline

    from repro_torch.kernels.flash_attention.ops import _DTYPE_CODES

    fn = build_baseline(path, "flash_fwd", "flash_attention_fwd",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p])

    def call(q, k, v, causal, window, q_offset, train=False):
        B, Sq, Hq, hd = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if train else None
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if train else None, _DTYPE_CODES[q.dtype], B, Sq, k.shape[1],
                 Hq, k.shape[2], hd, int(causal), window or 0, q_offset, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline forward: CUDA error {err}")
        return out
    return call


# (name, B, S, Hq, Hkv, hd, window): the shapes --baseline times, each in
# the serving form at B = 1 and the training form at B = 4
BASELINE_SHAPES = (("gemma-2b", 512, 8, 1, 256, None), ("gemma-2b", 512, 8, 1, 256, 256),
                   ("granite-moe-1b-a400m", 512, 16, 8, 64, None),
                   ("olmoe-1b-7b", 512, 16, 16, 128, None),
                   ("h2o-danube3-4b", 512, 32, 8, 120, None))


def compare_baseline(torch, path: str, gen) -> None:
    """Time another ``flash_fwd.cu`` against this one in turns."""
    from torch_train_probe import device_ms

    from repro_torch.kernels.flash_attention import (flash_attention_cuda, flash_attention_plain,
                                                     flash_attention_train_cuda)

    base = baseline_fwd(torch, path)
    for name, S, Hq, Hkv, hd, window in BASELINE_SHAPES:
        for B, train in ((1, False), (4, True)):
            q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            mine = flash_attention_train_cuda if train else flash_attention_cuda
            tag = (f"baseline {Path(path).name} vs this, {'train' if train else 'serve'} fwd "
                   f"{name} B={B} S={S} {Hq}/{Hkv} heads of {hd} bf16 window={window}")
            try:
                got = base(q, k, v, True, window, 0, train)
            except RuntimeError as exc:
                print(f"{tag}: baseline n/a ({exc})", flush=True)
                continue
            ref = flash_attention_plain(q, k, v, True, window, 0)
            err = (got.float() - ref.float()).abs().max().item()
            times = [device_ms(torch, lambda f=f: f(q, k, v, True, window, 0))
                     for f in (lambda *a: base(*a, train), mine, mine,
                               lambda *a: base(*a, train))]
            print(f"{tag}: device ms baseline {times[0]:.4f} / {times[3]:.4f}, this "
                  f"{times[1]:.4f} / {times[2]:.4f}; baseline max abs err {err:.3e}", flush=True)


# the planted fault: the tensor-core form's KV walk rounds its tile count
# down, so the last tile is skipped where the keys end inside it
PLANT = ("const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;",
         "const int n_tiles = k_end > k_begin ? (k_end - k_begin) / kTcBK : 0;")


def check_planted(torch) -> int:
    """chip_smoke's bf16 frontend bar against this kernel and the planted
    copy; returns the number of shapes where either is on the wrong side."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    text = _build.SOURCES["flash_fwd"].read_text()
    if text.count(PLANT[0]) != 1:
        sys.exit("--plant: the KV walk's tile count is not where the fault is planted")
    with tempfile.TemporaryDirectory() as tmp:
        planted = Path(tmp) / "flash_fwd_planted.cu"
        planted.write_text(text.replace(*PLANT))
        base = baseline_fwd(torch, str(planted))
    wrong = 0
    for B, Sq, Skv, causal, heads, tag in cs.FRONTEND_FLASH:
        q, k, v = cs.flash_case(torch, Sq, B=B, Skv=Skv, **heads)
        exact = flash_attention_plain(q.float(), k.float(), v.float(), causal, None, 0, 1024, 512)
        outs = {"this": flash_attention_cuda(q, k, v, causal, None, 0),
                "plain bf16": flash_attention_plain(q, k, v, causal, None, 0, 1024, 512),
                "planted": base(q, k, v, causal, None, 0)}
        torch.cuda.synchronize()
        read = {name: ((o.float() - exact).abs().max().item(), cs.bf16_row_ulps(torch, o, exact))
                for name, o in outs.items()}
        ragged = Skv % 64 != 0
        bad = read["this"][1] > cs.BF16_ULPS or (ragged and read["planted"][1] <= cs.BF16_ULPS)
        wrong += bad
        print(f"planted fault, {tag} B={B} Sq={Sq} Skv={Skv} causal={causal} bf16 (bar "
              f"{cs.BF16_ULPS} ulps): " + "; ".join(
                  f"{name} max abs err {e:.3e} = {u:.2f} ulps" for name, (e, u) in read.items())
              + (" WRONG" if bad else ""), flush=True)
    return wrong


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help="another flash_fwd.cu to time against this one (repeatable)")
    parser.add_argument("--plant", action="store_true",
                        help="hold the bf16 frontend bar against a copy that skips the last "
                             "key tile")
    args = parser.parse_args()
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
             (2, 70, 50, 4, 2, 16, False, None, 0, f32),
             # head dims outside 16 / 32 / 64 / 128 / 256 (h2o-danube3-4b: 32 / 8 of 120)
             (1, 512, 512, 32, 8, 120, True, None, 0, bf16),
             (1, 512, 512, 32, 8, 120, True, 256, 0, bf16),
             (1, 2048, 2048, 32, 8, 120, True, None, 0, bf16),
             (2, 97, 97, 4, 2, 120, True, None, 0, f32),
             (2, 97, 100, 4, 2, 72, True, 30, 3, f16),
             (1, 70, 70, 4, 1, 200, False, None, 0, bf16),
             (2, 97, 97, 4, 2, 60, True, None, 0, bf16),
             (1, 33, 40, 2, 1, 7, True, None, 5, f16),
             (1, 50, 50, 4, 2, 100, True, 16, 0, f32)]
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
        print(f"{tag}: path={flash_attention_path(dt, hd)} err={err:.3e} repeat_equal={same} "
              f"{'ok' if ok else 'WRONG'} ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} "
              f"bound_ms={bound:.5f}", flush=True)
    for path in args.baseline:
        compare_baseline(torch, path, gen)
    if args.plant:
        failed += check_planted(torch)
    if failed:
        sys.exit(f"{failed} case(s) failed")


if __name__ == "__main__":
    main()
