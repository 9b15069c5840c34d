"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its limits and its metrics are found by name (``bench/harness/spec.py``).
Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``check``, each number compared beside its limit (also the last
lines on standard error).  Exits non-zero, printing no result, without
enough CUDA devices, or when JAX or the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import paths

    paths.setup()
    import torch

    from harness import check, spec, train

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = torch.cuda.get_device_name(0)
    log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}, on {kind}")

    r = train.run(cell, args.seed, args.seconds, trace=bool(args.trace), t_start=T_START)
    log(f"{cell.name}: set-up {r.setup_s:.3f} s (check readings {r.check_s:.3f} s), "
        f"window {r.window['steps']} steps in {r.window['wall_s']:.3f} s, "
        f"reference {r.reference_s:.3f} s")
    spans = sorted(r.window["spans"])
    log(f"{cell.name}: host ms a step min {1e3 * spans[0]:.1f} median "
        f"{1e3 * spans[len(spans) // 2]:.1f} max {1e3 * spans[-1]:.1f}; "
        f"{r.window['gc_collections']} garbage collections in the window")

    ctx = train.context(r, spec.peaks(kind))
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": max(r.setup_peak, r.window_peak)}
    result = {"correct": None, "attempted": r.window["steps"], "failed": 0,
              "metrics": metrics, "device": device}
    if r.trace is not None:
        device["busy_s"] = r.trace.busy_s
        device["window_s"] = r.trace.window_s
        result["breakdown"] = r.trace.breakdown()
    correct, shown = check.judge(r.numbers, cell.limits["limits"])
    result["correct"] = correct
    result["check"] = shown

    found = check.forbidden_modules(sys.modules)
    if found:
        log(f"the run loaded modules of JAX or of the JAX package: {found}")
        return 3
    log(f"correct {correct}")
    limits = cell.limits["limits"]
    for name, (value, where) in sorted(r.numbers.items(), key=lambda kv: kv[0] in limits):
        if isinstance(where, tuple):
            where = "".join(f"[{k!r}]" for k in where)
        beside = f"limit {limits[name]!r}" if name in limits else "not compared"
        log(f"check {name} {value!r} {beside} (worst: {where})"
            f"{'' if math.isfinite(value) else ' not finite'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
