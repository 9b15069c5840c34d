#!/usr/bin/env python3
"""Build the training kernels and check them, on one CUDA card.

    python3 scripts/torch_train_probe.py [--baseline FLASH_BWD_CU ...] [--splits] [--plant]

The short first call after a change to a backward kernel: compiles
``flash_fwd.cu`` (B3, whose training form also writes each row's
log-sum-exp), ``flash_bwd.cu`` (B3's backward) and ``lstm_cell.cu`` (B4 and
its backward) with ``-Xptxas -v`` and prints the registers, shared memory
and spills of every instantiation (the backward's tensor-core kernels
``flash_bwd_dkdv_mma`` / ``flash_bwd_dq_mma`` and its SIMT ones), then runs

* the training forward at gemma-2b's shape and others: its output must be
  the serving kernel's bit for bit, its log-sum-exp within the tolerance of
  the plain version's;
* ``flash_attention_bwd_cuda`` against ``flash_attention_bwd_plain`` at
  gemma-2b's training shape (B = 4, S = 512, 8 / 1 heads of 256, bf16),
  with a 256-token window, in f32 and fp16, at granite's (16 / 8 heads of
  64), olmoe's (16 of 128) and h2o-danube3-4b's (32 / 8 of 120) widths,
  every compiled head dim and some between them (72, 200; 7 and 60 on the
  CUDA cores), ragged lengths,
  ``q_offset``, non-causal calls, every element compared, twice for the
  same bits, with the form (``flash_attention_bwd_path``) and split
  (``flash_bwd_splits``) each call takes;
* ``lstm_cell_bwd_cuda`` against ``lstm_cell_bwd_plain`` (N = 64 and 256,
  H = 1024; bf16 gates with f32 state; a ragged N = 37, H = 200);
* autograd through both training ops on the card against the CPU.

Prints per case the max abs error and the ms per call from CUDA events
around 20 calls (host launch included) beside the plain version and one
PyTorch library call (SDPA forward + backward; ``aten.
_thnn_fused_lstm_cell_backward_impl``).  With ``--baseline`` (given once
or more), also builds each such copy of ``flash_bwd.cu`` (an earlier
version with the same C entry point) and times it against this one at the
training shapes of gemma-2b (causal, and with a 256-token window),
granite-moe-1b-a400m, olmoe-1b-7b and h2o-danube3-4b (B = 4, S = 512) in
turns (baseline, this, this, baseline), device ms from ``torch.profiler``;
a shape the copy refuses reads n/a.  With ``--splits``, times the
tensor-core backward at every split of a key tile's query heads the C
entry point takes (``flash_bwd_splits`` picks one), per kernel (D pass,
dK / dV, dQ), at gemma-2b's training shape causal and with a 256-token
window, a 2048-token gemma call and granite's widths.  With ``--plant``,
holds chip_smoke's bar for B3-bwd's bf16 frontend rows (dq, dk and dv
within ``BF16_BWD_ULPS`` bf16 ulps of each output row's largest value of
the plain backward run in f32 on the same bf16 inputs) against two
planted faults, each a copy of ``flash_bwd.cu`` written to a temporary
directory and built beside this one: ``walk``, whose tensor-core dK / dV
walk stops one query tile short (its last 32 rows, or whisper's
encoder's ragged 28, never reach dk and dv), and ``split1``, which hands
P and dS to the tensor cores as one bf16 term each instead of three.  At
chip_smoke's frontend shapes (``FRONTEND_BWD``, its inputs) it prints
this kernel's, the bf16 plain version's and each planted copy's max abs
error and ulps; it fails if this kernel misses the bar, the ``walk``
copy meets it at whisper's shapes or the ``split1`` copy meets it at
any shape.  Prints the card's
name and power limit first; exits non-zero if any case is wrong.
``chip_smoke.py`` takes the device times of the main path.
"""
import argparse
import ctypes
import hashlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


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


def kernel_ms(torch, fn, iters: int = 20) -> dict:
    """Device ms of one call per kernel name (``torch.profiler`` over
    ``iters`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("<")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + (e.time_range.end - e.time_range.start) / iters / 1e3
    return by


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call: the kernels ``torch.profiler`` records over
    ``iters`` calls, summed, per call."""
    return sum(kernel_ms(torch, fn, iters).values())


def split_sweep(torch, gen) -> None:
    """The tensor-core backward at every split its C entry point takes,
    device ms per kernel, each against the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                     flash_attention_train_cuda,
                                                     flash_bwd_splits)
    from repro_torch.kernels.flash_attention.ops import _DTYPE_CODES, _bwd_lib

    lib = _bwd_lib()

    def call(a, splits):
        do, q, k, v, o, lse, causal, window, q_offset = a
        B, Sq, Hq, hd = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        D = torch.empty((B, Hq, Sq), dtype=torch.float32, device="cuda")
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Sq, k.shape[1], Hq, k.shape[2], hd, int(causal),
            window or 0, q_offset, hd ** -0.5, splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
        return dq, dk, dv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, Hq, Hkv, hd, window in ((4, 512, 8, 1, 256, None), (4, 512, 8, 1, 256, 256),
                                      (1, 2048, 8, 1, 256, None), (2, 512, 16, 8, 64, None)):
        q, do = (torch.randn((B, S, Hq, hd), generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        o, lse = flash_attention_train_cuda(q, k, v, True, window, 0)
        a = (do, q, k, v, o, lse, True, window, 0)
        ref = flash_attention_bwd_plain(*a)
        for splits in (s for s in (1, 2, 4, 8) if (Hq // Hkv) % s == 0):
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(call(a, splits), ref))
            by = kernel_ms(torch, lambda: call(a, splits))
            chosen = " (chosen)" if splits == flash_bwd_splits(B, S, Hq, Hkv, sms) else ""
            print(f"splits B={B} S={S} {Hq}/{Hkv} heads of {hd} window={window}: "
                  f"splits={splits}{chosen} {sum(by.values()):.4f} ms: "
                  + " ".join(f"{n}={ms:.4f}" for n, ms in sorted(by.items()))
                  + f" err={err:.3e}", flush=True)


def build_baseline(path: str, kernel: str, entry: str, argtypes: list):
    """Another copy of ``kernel``'s source, built into the build directory
    under a name of its own (by content), with this tree's headers beside
    ``kernel``'s source on the include path; returns its C entry ``entry``."""
    from repro_torch.kernels import _build

    src = Path(path).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = _build.build_dir() / f"lib{src.stem}_baseline-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", str(_build.SOURCES[kernel].parent),
                    "-o", str(out), str(src)], check=True)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def baseline_bwd(torch, path: str):
    """The backward of another ``flash_bwd.cu`` (the same C entry point);
    returns a call with ``flash_attention_bwd_cuda``'s arguments, at the
    split this version's ``flash_bwd_splits`` picks."""
    from repro_torch.kernels.flash_attention import flash_bwd_splits
    from repro_torch.kernels.flash_attention.ops import _DTYPE_CODES

    fn = build_baseline(path, "flash_bwd", "flash_attention_bwd",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(dout, q, k, v, o, lse, causal, window, q_offset):
        B, Sq, Hq, hd = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        D = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPE_CODES[q.dtype], B, Sq, Skv, Hq, Hkv, hd, int(causal), window or 0,
                 q_offset, hd ** -0.5, flash_bwd_splits(B, Skv, Hq, Hkv, sms),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline backward: CUDA error {err}")
        return dq, dk, dv
    return call


# (name, B, S, Hq, Hkv, hd, window): the training shapes --baseline times
BASELINE_SHAPES = (("gemma-2b", 4, 512, 8, 1, 256, None), ("gemma-2b", 4, 512, 8, 1, 256, 256),
                   ("granite-moe-1b-a400m", 4, 512, 16, 8, 64, None),
                   ("olmoe-1b-7b", 4, 512, 16, 16, 128, None),
                   ("h2o-danube3-4b", 4, 512, 32, 8, 120, None))


# the planted faults, as (text, its replacement) in flash_bwd.cu: "walk"
# counts the tensor-core dK / dV walk one query tile fewer, so the rows of
# its last tile never reach dk and dv; "split1" gives P and dS one bf16
# term each (split1 beside tensor_core.cuh's split3, its other two terms 0)
SPLIT1 = """#include "tensor_core.cuh"

namespace {
template <typename T>
__device__ __forceinline__ void split1(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  mid = 0u;
  lo = 0u;
}
}  // namespace
"""
PLANTS = {
    "walk": (("const int n_qt = q_end > q_begin ? (q_end - q_begin + kQT - 1) / kQT : 0;",
              "const int n_qt = q_end > q_begin ? (q_end - q_begin + kQT - 1) / kQT - 1 : 0;",
              1),),
    "split1": (('#include "tensor_core.cuh"\n', SPLIT1, 1), ("split3<T>(", "split1<T>(", 5)),
}


def check_planted(torch) -> int:
    """chip_smoke's bf16 bar for B3-bwd's frontend rows against this kernel
    and the planted copies; returns the number of shapes where any is on
    the wrong side."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_train_cuda)

    calls = {"this": flash_attention_bwd_cuda, "plain bf16": flash_attention_bwd_plain}
    with tempfile.TemporaryDirectory() as tmp:
        for plant, edits in PLANTS.items():
            text = _build.SOURCES["flash_bwd"].read_text()
            for old, new, n in edits:
                if text.count(old) != n:
                    sys.exit(f"--plant {plant}: {old!r} is not where the fault is planted")
                text = text.replace(old, new)
            path = Path(tmp) / f"flash_bwd_{plant}.cu"
            path.write_text(text)
            calls[plant] = baseline_bwd(torch, str(path))
    wrong = 0
    for B, Sq, Skv, causal, heads, tag in cs.FRONTEND_BWD:
        q, k, v, do = cs.frontend_bwd_case(torch, B, Sq, Skv, heads["Hq"], heads["Hkv"],
                                           heads["hd"])
        out, lse = flash_attention_train_cuda(q, k, v, causal, None, 0)
        args = (do, q, k, v, out, lse, causal, None, 0)
        exact = cs.bwd_exact(torch, args)
        read = {name: cs.bwd_row_ulps(torch, fn(*args), exact) for name, fn in calls.items()}
        bar = cs.BF16_BWD_ULPS
        bad = (read["this"][0] > bar or read["split1"][0] <= bar
               or (tag.startswith("whisper") and read["walk"][0] <= bar))
        wrong += bad
        print(f"planted fault, {tag} B={B} Sq={Sq} Skv={Skv} causal={causal} bf16 backward "
              f"(bar {bar} ulps): " + "; ".join(
                  f"{name} max abs err {e:.3e} = {u:.2f} ulps" for name, (u, e) in read.items())
              + (" WRONG" if bad else ""), flush=True)
        del exact, q, k, v, do, out, lse
    return wrong


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help="another flash_bwd.cu to time against this one (repeatable)")
    parser.add_argument("--splits", action="store_true",
                        help="time the tensor-core backward at every split")
    parser.add_argument("--plant", action="store_true",
                        help="hold the bf16 frontend backward bar against copies whose dK / dV "
                             "walk skips its last query tile or whose P and dS are one bf16 "
                             "term")
    args = parser.parse_args()
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_path,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_attention_train,
                                                     flash_attention_train_cuda, flash_bwd_splits)
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
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln
                 or "Function properties" in ln]
        print(f"--- {name}\n" + "\n".join(lines))
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
             (1, 33, 33, 2, 2, 32, True, None, 0, f16),
             (2, 1, 1, 8, 1, 64, True, None, 0, bf16),
             (1, 333, 333, 16, 2, 128, True, 100, 0, bf16),
             (2, 97, 97, 4, 1, 32, True, 9, 0, f32),
             (2, 40, 100, 4, 2, 256, True, 30, 60, bf16),
             (2, 70, 50, 4, 2, 128, False, None, 0, f32),
             (2, 70, 50, 4, 2, 128, False, None, 0, bf16),
             (1, 33, 80, 8, 1, 64, False, 20, 7, f16),
             (3, 97, 97, 16, 2, 16, True, None, 5, bf16),
             # head dims outside 16 / 32 / 64 / 128 / 256 (h2o-danube3-4b: 32 / 8 of 120)
             (4, 512, 512, 32, 8, 120, True, None, 0, bf16),
             (1, 333, 333, 32, 8, 120, True, 256, 0, bf16),
             (2, 70, 50, 4, 2, 120, False, None, 0, f32),
             (1, 200, 200, 4, 1, 72, True, 50, 0, f16),
             (2, 97, 97, 4, 2, 60, True, None, 0, bf16),
             (2, 33, 33, 2, 1, 7, True, None, 3, bf16),
             (1, 70, 70, 4, 2, 200, True, None, 0, bf16)]
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
               f"form={flash_attention_bwd_path(dt, hd)} "
               f"splits={flash_bwd_splits(B, Skv, Hq, Hkv, sms)} "
               f"bwd_ms={ms:.4f} train_fwd_ms={fwd_ms:.4f} plain_bwd_ms={plain_ms:.4f} "
               f"sdpa_fwd_bwd_ms={sdpa_ms}")

    for path in args.baseline:
        base = baseline_bwd(torch, path)
        for name, B, S, Hq, Hkv, hd, window in BASELINE_SHAPES:
            q, do = (torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(bf16)
                     for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(bf16)
                    for _ in range(2))
            out, lse = flash_attention_train_cuda(q, k, v, True, window, 0)
            a = (do, q, k, v, out, lse, True, window, 0)
            tag = (f"baseline {Path(path).name} vs this, bwd {name} B={B} S={S} {Hq}/{Hkv} "
                   f"heads of {hd} bf16 window={window}")
            try:
                got = base(*a)
            except RuntimeError as exc:
                print(f"{tag}: baseline n/a ({exc})", flush=True)
                continue
            ref = flash_attention_bwd_plain(*a)
            err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, ref))
            times = [device_ms(torch, lambda f=f: f(*a))
                     for f in (base, flash_attention_bwd_cuda, flash_attention_bwd_cuda, base)]
            print(f"{tag}: device ms baseline {times[0]:.4f} / {times[3]:.4f}, this "
                  f"{times[1]:.4f} / {times[2]:.4f}; baseline max abs err {err:.3e}", flush=True)

    if args.splits:
        split_sweep(torch, gen)
    if args.plant:
        failed += check_planted(torch)

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
