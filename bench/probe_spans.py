"""The program's spans on the chip, for one cell, in one process.

    python bench/probe_spans.py --workload <cell> --seed <n> [--seconds 10] [--cost 30 [--quads 2]]

Set-up and a window of ``--seconds`` as ``bench/run.py`` runs them, then the
two traced segments the harness records (``harness.train.traced``), then
the spans segment (``harness.spans.traced``): ``trace_steps`` more steps
with the program's recorder on under a device-only profiler.  Prints one
JSON line: the clock offset, the share of the device time attributed to
a span, the phases' device ms against the busy ms, the per-phase table, the
idle gaps by span, the span-fed per-layer quantities (optimizer ms and
launches, AdamW's roofline, routing ms, slot fill, kept share) and the
shares of the routing and expert kernels inside their spans.  With
``--cost S``: one window of S seconds with the recorder off, not counted,
then ``--quads`` times windows of S seconds off, on, on, off, each whole
passes over the pool of batches: each window's tokens/s and host ms a step (the
``train_step`` calls), and each quad's on / off ratios.  Last, the reference's kept claims a layer beside
the program's counter, and the check's numbers.  The benchmark's own runs
never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROUTING_KERNELS = ("indexing_backward_kernel", "tensor_kernel_scan_outer_dim")
GMM_KERNELS = ("gmm_", "moe_gmm")


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def phases(s: dict, spans) -> dict:
    """Device ms, launches, idle ms and host ms a step of each phase (each
    inclusive of its children) and of the MoE parts (their own kernels)."""
    lab = s["labels"]

    def row(labels, own=False):
        pre = "self_" if own else ""
        got = [lab[x] for x in labels if x in lab]
        if not got:
            return None
        return {"device_ms": sum(g[pre + "device_ms"] for g in got),
                "launches": sum(g[pre + "launches"] for g in got),
                "idle_ms": sum(g[pre + "idle_ms"] for g in got),
                "host_ms": sum(g["host_ms"] for g in got)}

    rows = {p: row((p,)) for p in spans.PHASES + ("model.recompute", "optim.adamw",
                                                  "optim.clip", "optim.update")}
    rows["routing"] = row(spans.ROUTING_LABELS, own=True)
    rows["experts"] = row(spans.EXPERT_LABELS, own=True)
    return {k: v for k, v in rows.items() if v is not None}


def cost_windows(r, prog, seconds: float, quads: int, trace) -> dict:
    """Windows of ``seconds`` with the recorder off and on (module
    docstring), and the ratios on / off of each quad."""
    import torch

    mix = r.cell.traffic
    windows = []
    for on in (False,) + (False, True, True, False) * quads:
        trace.reset()
        if on:
            trace.enable()
        n, host = 0, 0.0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            prog.state, _ = prog.step(prog.state, prog.pool[n % len(prog.pool)])
            host += time.perf_counter() - a
            n += 1
            if time.perf_counter() - t0 >= seconds and n % len(prog.pool) == 0:
                break
        torch.cuda.synchronize(r.device)
        wall = time.perf_counter() - t0
        trace.disable()
        spans_n = len(trace.snapshot()["spans"]) if on else 0
        trace.reset()
        windows.append({"recorder": "on" if on else "off", "steps": n, "wall_s": wall,
                        "tokens_per_s": n * int(mix["batch"]) * int(mix["seq_len"]) / wall,
                        "host_ms_per_step": 1e3 * host / n, "spans_per_step": spans_n / n})
    windows = windows[1:]
    ratios = []
    for q in range(quads):
        w = windows[4 * q:4 * q + 4]
        ratios.append({k: (w[1][k] + w[2][k]) / (w[0][k] + w[3][k])
                       for k in ("tokens_per_s", "host_ms_per_step")})
    return {"windows": windows, "quad_ratios": ratios}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", type=float, default=0.0)
    ap.add_argument("--quads", type=int, default=2)
    ap.add_argument("--out", default="build/bench/spans")
    args = ap.parse_args(argv)

    from harness import paths

    paths.setup()
    import torch

    from harness import spans, spec, train
    from repro_torch.core import trace

    cell = spec.load_cell(args.workload)
    kind = torch.cuda.get_device_name(0)
    out = Path(args.out)
    r = train.Run(cell=cell, seed=args.seed, device=torch.device("cuda"))
    prog = train.start(r)
    train.measure(r, prog, args.seconds, T_START)
    train.traced(r, prog, out)
    s = spans.traced(r, prog, out)
    result = {"cell": cell.name, "seed": args.seed, "device": kind, "card": power_limit(),
              "window_tokens_per_s": r.window["tokens"] / r.window["wall_s"],
              "existing": {"device_idle": 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s),
                           "launches_per_step": len(r.trace.kernels) / r.trace.steps,
                           "busy_ms_per_step": 1e3 * r.trace.busy_s / r.trace.steps}}
    peaks = spec.peaks(kind)
    model = cell.config["model"]
    layout = spec.reference(cell.config, cell.bench).layout(model)
    least = spec.roofline("adamw").least_bytes(layout)
    phase_sum = sum(s["labels"][p]["device_ms"] for p in spans.PHASES if p in s["labels"])
    result["spans"] = {
        **{k: s[k] for k in ("offset_us", "within_us", "markers", "marker_spans",
                             "marker_kernels", "consistent", "steps", "launch_events",
                             "window_ms", "busy_ms", "device_ms", "idle_ms",
                             "launches", "kernels_by_step", "launch_to_start_us",
                             "attributed_share", "on_thread_share", "unlaunched_ms")},
        "phase_sum_ms": phase_sum,
        "phase_sum_over_busy": phase_sum / s["busy_ms"] if s["busy_ms"] else None,
        "phases": phases(s, spans),
        "idle_by_span": dict(list(s["idle_by_span"].items())[:12]),
        "metrics": {
            "optimizer_ms_per_step.train": spans.optimizer_ms(s),
            "optimizer_launches_per_step.train": spans.optimizer_launches(s),
            "adamw_roofline.train": spans.adamw_roofline(s, least, peaks["hbm_bytes_per_s"]),
            "routing_ms_per_step.train": spans.routing_ms(s),
            "moe_slot_fill.train": spans.moe_slot_fill(s),
            "moe_kept_share.train": spans.moe_kept_share(s)},
        "adamw_least_gb": least / 1e9,
        "routing_kernels_in_routing": spans.share_in(s, ROUTING_KERNELS, spans.ROUTING_LABELS),
        "gmm_in_experts": spans.share_in(s, GMM_KERNELS, spans.EXPERT_LABELS),
        "top_kernels": sorted(((k, sum(w.values()), max(w, key=w.get))
                               for k, w in s["by_kernel"].items()), key=lambda x: -x[1])[:12],
    }
    if args.cost:
        result["cost"] = cost_windows(r, prog, args.cost, args.quads, trace)
    # the reference's kept claims a layer (its first steps), beside the counter's
    train.free(r, prog)
    train.judge_reference(r, prog)
    kept = [k for step in r.reference.get("kept", []) for k in step]
    if kept:
        result["kept_a_layer"] = {
            "reference": sum(kept) / len(kept),
            "program": s["counters"]["moe.kept"]["per_step"] / model["n_layers"]}
    result["check"] = {k: v for k, (v, _) in r.numbers.items()}
    (out / f"{cell.name}.probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
