#!/usr/bin/env python3
"""Build the backward kernels of B5, B6 and B7 and check them, on one CUDA card.

    python3 scripts/torch_family_bwd_probe.py [--train]

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
  3 AdamW steps at B=4, S=512, launch counts, peak memory.

Prints the card's name and power limit first; exits non-zero if any phase
failed (the failures listed last).
"""
import argparse
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true", help="also the full-width train phases")
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
            if "Compiling entry" in line or "registers" in line or "spill" in line:
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
                        "library_dw_ms")
                print(f"{kernel} {case}: " + " ".join(
                    f"{k}={r[k]:.5g}" if isinstance(r.get(k), float) else f"{k}={r[k]}"
                    for k in keys if k in r), flush=True)

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
