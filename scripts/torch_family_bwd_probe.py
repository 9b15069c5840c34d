#!/usr/bin/env python3
"""Build the backward kernels of B5, B6 and B7 and check them, on one CUDA card.

    python3 scripts/torch_family_bwd_probe.py [--train] [--baseline-moe FILE]
                                              [--baseline-ssm FILE] [--variants]

The short first call after a change to ``moe_gmm.cu``, ``ssm_scan.cu`` or
``rglru_scan.cu``: compiles them (and B3's and B4's kernels, which the
training paths and ``chip_smoke.train_kernel_rows`` run) with ``-Xptxas
-v`` and prints the registers, shared memory and spills of every
instantiation, then runs ``chip_smoke.py``'s own checks of the training
kernels, each phase on its own so that one failure does not hide the
next:

* ``family_bwd_kernel_rows``: ``moe_gmm_bwd_cuda``, ``ssm_scan_bwd_cuda``
  and ``rglru_scan_bwd_cuda`` against their plain backwards at the
  training paths' shapes, every element, twice for the same bits, with
  device times beside the plain version and ``torch.bmm``;
* ``train_kernel_rows``: B3's backward, granite-moe's (16 / 8 heads of 64)
  and recurrentgemma's (10 / 1 heads of 256) widths included, and B4's;
* ``small_train_arch`` for the smoke granite-moe-1b-a400m, falcon-mamba-7b
  and recurrentgemma-2b configs in f32: loss and gradients on the card
  against the CPU, exact launch counts, the captured loss + gradient graph
  three ways;
* with ``--train``, ``family_train_phase`` for the three families at full
  width (falcon-mamba-7b cut to chip_smoke's ``FALCON_TRAIN_LAYERS``):
  3 AdamW steps at B=4, S=512, launch counts, peak memory;
* with ``--baseline-moe FILE`` / ``--baseline-ssm FILE``: another
  ``moe_gmm.cu`` / ``ssm_scan.cu`` (say the parent commit's, written into
  ``scratch_chip/`` with ``git show``; its C entry ``moe_gmm_bwd`` without
  the ``dw_first`` argument, its ``ssm_scan_bwd`` without checkpoints),
  built beside this tree's and timed against it in turns (baseline, this,
  this, baseline; ``torch.profiler`` device ms) at the training shapes:
  granite-moe's two products (and each half alone), falcon-mamba's scan
  backward (this tree's with its training forward beside it);
* with ``--variants``: where B5-bwd's time goes.  Copies of this tree's
  ``moe_gmm.cu`` with one part of ``gmm_bwd_wgmma`` changed by text
  substitution, built and timed beside it at granite-moe's products:
  ``register_epilogue`` (each thread stores its accumulators straight
  from registers, a masked bf16 pair at a time, instead of through
  shared memory and TMA stores), ``no_store`` (no output written),
  ``no_load`` (the producer signals each stage without copying it) and
  ``mma_only`` (neither); and the designs this one replaced:
  ``release_late`` (a stage handed back one k-block late, once the next
  block's products are issued), ``stages3_whole`` (a 3-stage ring, each
  warpgroup's output staged whole, 32 KB) and both together.  The four
  diagnostic copies' outputs are wrong by construction: only their times
  mean anything.

Prints the card's name and power limit first; exits non-zero if any phase
failed (the failures listed last).
"""
import argparse
import ctypes
import hashlib
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


class PhaseFailed(Exception):
    pass


# gmm_bwd_wgmma's epilogue, from its first line to the commit of the
# tile's last TMA stores
_EPILOGUE = ("    const int N = t.prod ? p.F : p.D;\n#pragma unroll\n    for (int part",
             'asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");\n      }\n    }\n')
# the consumers' hand-back of a stage: as soon as the stage's own products
# are done, or one k-block late (once the next block's are issued)
_RELEASE = ('      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");\n'
            '      fence_acc(acc);\n'
            '      if (lane == 0) mbar_arrive(empty0 + 8 * s);\n'
            '      if (++s == kWStages) { s = 0; phase ^= 1; }\n'
            '    }\n')
_RELEASE_LATE = ('      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");\n'
                 '      fence_acc(acc);\n'
                 '      if (kb > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((s + kWStages - 1) % kWStages));\n'
                 '      if (++s == kWStages) { s = 0; phase ^= 1; }\n'
                 '    }\n'
                 '    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");\n'
                 '    fence_acc(acc);\n'
                 '    if (lane == 0) mbar_arrive(empty0 + 8 * ((s + kWStages - 1) % kWStages));\n')
_REGISTER_EPILOGUE = """    const int M = t.prod ? p.D : p.C, N = t.prod ? p.F : p.D;
    bf16* out = (t.prod ? dw : dx) + (int64_t)t.e * M * N;
    const int r0 = t.mt * kWM + wg * 64 + warp * 16 + lane / 4;
    const int c0 = t.nt * kWN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + 8 * j;
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * N + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
"""
_KEEP_LIVE = '    if (acc[0] == -1234.5f && acc[127] == -1.0f) asm volatile("trap;");\n'


def moe_variants(src: str) -> dict[str, str]:
    """``moe_gmm.cu`` with one part of gmm_bwd_wgmma changed (see
    ``--variants``); each keeps the C entry and its arguments."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"variant anchor not found in moe_gmm.cu: {old[:60]!r}")
        return text.replace(old, new)

    def epilogue(text, new):
        a = text.index(_EPILOGUE[0])
        b = text.index(_EPILOGUE[1], a) + len(_EPILOGUE[1])
        return text[:a] + new + text[b:]

    reg = epilogue(src, _REGISTER_EPILOGUE)
    reg = sub(reg, "              WProblem p) {",
              "              WProblem p, bf16* __restrict__ dx, bf16* __restrict__ dw) {")
    reg = sub(reg, "dx_out, dw_out, p);", "dx_out, dw_out, p, dx, dw);")
    no_load = sub(src, "int c2, uint32_t bar) {\n  asm volatile(",
                  "int c2, uint32_t bar) {\n  return;\n  asm volatile(")
    no_load = sub(no_load, "        mbar_expect_tx(full, kWStage);\n", "        mbar_arrive(full);\n")
    late = sub(src, _RELEASE, _RELEASE_LATE)
    whole = sub(sub(src, "constexpr int kWStages = 4;", "constexpr int kWStages = 3;"),
                "constexpr int kWOutBoxes = 2;", "constexpr int kWOutBoxes = 4;")
    return {"register_epilogue": reg, "no_store": epilogue(src, _KEEP_LIVE),
            "no_load": no_load, "mma_only": epilogue(no_load, _KEEP_LIVE),
            "release_late": late, "stages3_whole": whole,
            "stages3_whole_release_late": sub(whole, _RELEASE, _RELEASE_LATE)}


def moe_variant_times(torch, cs) -> None:
    """Each ``moe_variants`` copy built beside this tree's kernel and timed
    against it (device ms) at granite-moe's two training products."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import ops

    d = _build.build_dir() / "variants"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    src = _build.SOURCES["moe_gmm"]
    for name, text in moe_variants(src.read_text()).items():
        path = d / f"moe_gmm_{name}.cu"
        path.write_text(text)
        out = d / f"libmoe_gmm_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-I", str(src.parent), "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    fns = {"this": ops._lib().moe_gmm_bwd}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-2000:]}")
        fn = ctypes.CDLL(str(out)).moe_gmm_bwd
        fn.argtypes = ops._lib().moe_gmm_bwd.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    for E, C, D, F in ((32, 640, 1024, 512), (32, 640, 512, 1024)):
        x, w = cs.moe_gmm_case(torch, E, C, D, F, torch.bfloat16)
        dy = (torch.randn((E, C, F), device="cuda") * 0.25 * C ** -0.5).to(x.dtype)
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        first = int(ops.moe_gmm_bwd_dw_first(C, D, F))
        times = {}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                         1, E, C, D, F, 1, first, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant: CUDA error {err}")
            times[name] = cs.device_ms(torch, call, 50)
        wt = w.transpose(1, 2)
        times["torch.bmm pair"] = cs.device_ms(
            torch, lambda: (torch.bmm(dy, wt), torch.bmm(x.transpose(1, 2), dy)), 50)
        print(f"moe_gmm_bwd variants, E={E} C={C} D={D} F={F} bf16, device ms: "
              + " ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)


def build_baseline(path: str, name: str) -> ctypes.CDLL:
    """Another kernel source, built into the build directory beside this
    tree's libraries (named by its hash); its ``-Xptxas -v`` lines printed."""
    from repro_torch.kernels import _build

    src = Path(path).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = _build.build_dir() / f"lib{name}_baseline-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), "-Xptxas", "-v", *_build._ARCH_FLAGS, "-std=c++17",
                          "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)],
                         capture_output=True, text=True, check=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name} baseline: {line.strip()}")
    return ctypes.CDLL(str(out))


def in_turns(torch, device_ms, base, this) -> list[float]:
    """Device ms of baseline, this, this, baseline, one after the other."""
    return [device_ms(torch, f, 20) for f in (base, this, this, base)]


def moe_baseline(torch, cs, path: str) -> None:
    """The parent's two-launch ``mma.sync`` backward against this tree's
    one-launch ``wgmma`` kernel at granite-moe's training products, both
    halves and each alone."""
    from repro_torch.kernels.moe_gmm import ops

    fn = build_baseline(path, "moe_gmm").moe_gmm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for E, C, D, F in ((32, 640, 1024, 512), (32, 640, 512, 1024)):
        x, w = cs.moe_gmm_case(torch, E, C, D, F, torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(11 + C + D)
        dy = (torch.randn((E, C, F), generator=gen, device="cuda") * 0.25 * C ** -0.5).to(x.dtype)
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        ref = ops.moe_gmm_bwd_plain(x, w, dy)
        for half, outs in (("dx+dw", (dx, dw)), ("dx", (dx, None)), ("dw", (None, dw))):
            ptrs = [None if o is None else o.data_ptr() for o in outs]

            def base(ptrs=ptrs):
                err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), *ptrs, 1, E, C, D, F, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"baseline moe_gmm_bwd: CUDA error {err}")

            this = (lambda: ops.moe_gmm_bwd_cuda(x, w, dy)) if half == "dx+dw" else \
                cs.moe_gmm_bwd_half(torch, x, w, dy, half)
            base()
            torch.cuda.synchronize()
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, ref) if o is not None)
            t = in_turns(torch, cs.device_ms, base, this)
            print(f"moe_gmm_bwd baseline vs this, E={E} C={C} D={D} F={F} bf16 {half}: device "
                  f"ms baseline {t[0]:.4f} / {t[3]:.4f}, this {t[1]:.4f} / {t[2]:.4f}; baseline "
                  f"max abs err {err:.3e}", flush=True)


def ssm_baseline(torch, cs, path: str) -> None:
    """The parent's seven-pass scan backward (no checkpoints) against this
    tree's four-pass one at falcon-mamba's training shape, and the serving
    forward against the training forward."""
    from repro_torch.kernels.ssm_scan import ops

    lib = build_baseline(path, "ssm_scan")
    fn = lib.ssm_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    part_floats = lib.ssm_scan_bwd_part_floats
    part_floats.argtypes = [ctypes.c_longlong] * 3 + [ctypes.c_int]
    part_floats.restype = ctypes.c_longlong
    B, S, D, St = 4, 512, 8192, 16
    a, b, c, h = cs.ssm_scan_case(torch, B, S, D, St, torch.bfloat16, False)
    gen = torch.Generator(device="cuda").manual_seed(12 + S + D)
    dy = torch.randn((B, S, D), generator=gen, device="cuda") * D ** -0.5
    dh_last = torch.randn((B, D, St), generator=gen, device="cuda")
    ck = ops.ssm_scan_train_cuda(a, b, c, h)[2]
    outs = [torch.empty_like(a), torch.empty_like(a), torch.empty_like(c),
            torch.empty((B, D, St), device="cuda")]
    part = torch.empty((part_floats(B, S, D, St),), device="cuda")

    def base():
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None, dy.data_ptr(),
                 dh_last.data_ptr(), *(o.data_ptr() for o in outs), part.data_ptr(), 1, B, S, D,
                 St, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline ssm_scan_bwd: CUDA error {err}")

    base()
    got = ops.ssm_scan_bwd_cuda(a, b, c, h, dy, dh_last, ck)
    torch.cuda.synchronize()
    same = all(torch.equal(g, o) for i, (g, o) in enumerate(zip(got, outs)) if i != 2)
    t = in_turns(torch, cs.device_ms, base,
                 lambda: ops.ssm_scan_bwd_cuda(a, b, c, h, dy, dh_last, ck))
    f = in_turns(torch, cs.device_ms, lambda: ops.ssm_scan_cuda(a, b, c, h),
                 lambda: ops.ssm_scan_train_cuda(a, b, c, h))
    print(f"ssm_scan_bwd baseline vs this, B={B} S={S} D={D} St={St}: device ms baseline "
          f"{t[0]:.4f} / {t[3]:.4f}, this {t[1]:.4f} / {t[2]:.4f}; da / db / dh0 bit-equal to "
          f"the baseline's: {same}; forward serving {f[0]:.4f} / {f[3]:.4f}, training "
          f"{f[1]:.4f} / {f[2]:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true", help="also the full-width train phases")
    ap.add_argument("--baseline-moe", help="another moe_gmm.cu to time against this one")
    ap.add_argument("--baseline-ssm", help="another ssm_scan.cu to time against this one")
    ap.add_argument("--variants", action="store_true",
                    help="time copies of B5-bwd's kernel with one part changed")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build_all(["moe_gmm", "ssm_scan", "rglru_scan", "flash_fwd", "flash_bwd",
                              "lstm_cell"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    for name in ("moe_gmm", "ssm_scan", "rglru_scan"):
        for line in built[name]["log"].splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "arning" in line):
                print(f"{name}: {line.strip()}")

    failures: list[str] = []

    def fail(msg: str) -> None:
        raise PhaseFailed(msg)

    cs.fail = fail

    def phase(name, fn):
        t1 = time.perf_counter()
        try:
            out = fn()
            print(f"phase {name}: ok in {time.perf_counter() - t1:.1f}s", flush=True)
            return out
        except Exception as e:  # noqa: BLE001 - a probe reports every phase
            failures.append(f"{name}: {e}")
            print(f"phase {name}: FAILED: {e}", flush=True)
            if not isinstance(e, PhaseFailed):
                traceback.print_exc()
            return None

    def show(rows):
        for kernel, cases in (rows or {}).items():
            for case, r in cases.items():
                keys = ("max_abs_err", "ms", "event_ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "form", "splits", "dx_ms", "dw_ms", "library_dx_ms",
                        "library_dw_ms", "serving_ms")
                print(f"{kernel} {case}: " + " ".join(
                    f"{k}={r[k]:.5g}" if isinstance(r.get(k), float) else f"{k}={r[k]}"
                    for k in keys if k in r), flush=True)

    if args.baseline_moe:
        phase("baseline moe_gmm", lambda: moe_baseline(torch, cs, args.baseline_moe))
    if args.baseline_ssm:
        phase("baseline ssm_scan", lambda: ssm_baseline(torch, cs, args.baseline_ssm))
    if args.variants:
        phase("moe_gmm_bwd variants", lambda: moe_variant_times(torch, cs))
    show(phase("family_bwd_kernel_rows", lambda: cs.family_bwd_kernel_rows(torch)))
    show(phase("train_kernel_rows", lambda: cs.train_kernel_rows(torch)))
    for arch, tag in cs.SMALL_TRAIN_ARCHS[1:]:
        phase(f"small_train {arch}", lambda a=arch, t=tag: cs.small_train_arch(torch, a, t))
    if args.train:
        for arch, tag, layers in cs.FAMILY_TRAIN:
            phase(tag, lambda a=arch, t=tag, n=layers: cs.family_train_phase(torch, a, t, n))
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        sys.exit(1)
    print("all phases ok", flush=True)


if __name__ == "__main__":
    main()
