"""Multi-pod dry-run: trace every (architecture x input shape) cell as one
rank's share of a production mesh of H100s, check it fits HBM, and report
the roofline numerators (per-rank flops / bytes / collective traffic) —
the port of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu           # full sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k \\
        --mesh pod --smoke --device cpu --out chiprun_out/dryrun.json
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k --mesh pod --run

Where the reference lowers and compiles each cell on 512 forced host
devices and reads the compiled module's memory analysis, this process joins
PyTorch's ``fake`` process group as rank 0 of the mesh's world and traces
the rank's actual program (``launch.cells.rank_program``) with
``make_fx(tracing_mode="fake")``: nothing is allocated, and the trace's
tracked peak (``analysis.fx_cost.peak_bytes``) is the memory figure.
``--run`` (on the card) also runs rank 0's share once for real and records
its measured peak (``torch.cuda.max_memory_allocated``), whether it fits
the card's own memory, and the step's device time beside the roofline
bound.  Under the fake backend the collectives move no data, so the values
the program computes are not checked; memory, shapes and kernel launches
are real.  Train cells whose traced peak exceeds HBM are bumped to more
microbatches and traced again, as the reference bumps them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.analysis.fx_cost import module_cost, peak_bytes, trace
from repro_torch.analysis.roofline import H100_SXM, roofline_report
from repro_torch.configs.base import SHAPES
from repro_torch.dist.sharding import batch_axes
from repro_torch.launch.cells import (build_cell, rank_inputs, rank_program, served_archs,
                                      skip_reason)
from repro_torch.launch.mesh import describe_mesh, make_production_mesh
from repro_torch.models.api import model_flops

MAX_MEMORY_BUMPS = 4
FAKE_NOTE = ("rank 0 of a fake process group: collectives move no data, so the values are "
             "not checked; memory, shapes and kernel launches are real")


def init_fake_group(world: int, rank: int = 0) -> None:
    """Join PyTorch's ``fake`` process group as ``rank`` of ``world``: every
    collective returns at once, so one process runs one rank's share of a
    mesh of any size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count (the card's paths count them)."""
    from repro_torch.kernels import decode_attention, flash_attention, moe_gmm, rglru_scan
    from repro_torch.kernels import lstm_cell, moe_route, ssm_scan

    counts = {
        "paged_decode_attention": decode_attention.paged_decode_attention_cuda.launches,
        "decode_attention": decode_attention.decode_attention_cuda.launches,
        "decode_attention.lse":
            decode_attention.decode_attention_cuda.launches_by_form.get("lse", 0),
        "flash_attention": flash_attention.flash_attention_cuda.launches,
        "flash_attention_train": flash_attention.flash_attention_train_cuda.launches,
        "flash_attention_bwd": flash_attention.flash_attention_bwd_cuda.launches,
        "lstm_cell": lstm_cell.lstm_cell_cuda.launches,
        "moe_gmm": moe_gmm.moe_gmm_cuda.launches,
        "moe_gmm_bwd": moe_gmm.moe_gmm_bwd_cuda.launches,
        "moe_route_slots": moe_route.route_slots_cuda.launches,
        "ssm_scan": ssm_scan.ssm_scan_cuda.launches,
        "ssm_scan_train": ssm_scan.ssm_scan_train_cuda.launches,
        "ssm_scan_bwd": ssm_scan.ssm_scan_bwd_cuda.launches,
        "rglru_scan": rglru_scan.rglru_scan_cuda.launches,
        "rglru_scan_bwd": rglru_scan.rglru_scan_bwd_cuda.launches,
    }
    return counts


def graphi_record(program, inputs, name: str, runtime=None) -> dict:
    """Capture the rank's program into a scheduled ``Executable`` (fake
    inputs — no allocation) and report the Graphi planning artifacts under
    the port's ``H100`` model: node count, DAG width, best executor config,
    modelled makespan, critical path."""
    from repro_torch import api as graphi
    from repro_torch.core.cost_model import H100

    exe = graphi.compile(program, *inputs, hw=H100, backend="sim", runtime=runtime, name=name)
    g = exe.graph
    prof = exe.profile
    cp_len, cp = exe.critical_path
    return {
        "n_nodes": len(g),
        "width": g.width(),
        "n_executors": prof.best_n_executors,
        "team_size": prof.best_team_size,
        "policy": exe.schedule.policy,
        "sim_makespan_s": prof.best_makespan,
        "critical_path_s": cp_len,
        "critical_path_ops": len(cp),
    }


def run_rank_share(cell, device_mesh, device, *, seed: int = 0) -> dict:
    """Run rank 0's share of ``cell`` once on the card (after one call that
    builds and warms every path): the measured peak, the device time of the
    timed call (CUDA events), and the kernels it launched."""
    program = rank_program(cell, device_mesh)
    inputs = rank_inputs(cell, device, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    program(*inputs)
    before = kernel_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = program(*inputs)
    end.record()
    torch.cuda.synchronize()
    after = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    rec = {
        "run_peak_bytes": int(peak),
        "run_input_bytes": int(base),
        "card_bytes": int(total),
        "fits_hbm_measured": bool(peak <= total),
        "device_ms": float(start.elapsed_time(end)),
        "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        "outputs": len(out),
    }
    del out, inputs
    return rec


def run_cell(arch: str, shape_name: str, mesh, *, want_roofline: bool = True,
             want_graphi: bool = True, run: bool = False, smoke: bool = False,
             device: str = "cpu", verbose: bool = False, runtime=None) -> dict:
    """One cell's record (``status`` ok / skip / fail)."""
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": describe_mesh(mesh),
                           "smoke": smoke}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    n_ranks = mesh.size
    t0 = time.time()
    try:
        init_fake_group(n_ranks)
        dm = mesh.to_device_mesh(torch.device(device).type)
        cell = build_cell(arch, shape_name, mesh, smoke=smoke)
        for _bump in range(MAX_MEMORY_BUMPS + 1):
            program = rank_program(cell, dm)
            fake_inputs = rank_inputs(cell, device, fake=True)
            gm = trace(program, *fake_inputs)
            peak = peak_bytes(gm)
            if peak <= H100_SXM.hbm_bytes or cell.kind != "train":
                break
            mb = cell.plan.microbatches * 2
            dp = 1
            for a in batch_axes(mesh, cell.shape.global_batch):
                dp *= mesh.shape[a]
            if mb > cell.shape.global_batch // max(dp, 1) or cell.shape.global_batch % mb:
                break
            if verbose:
                print(f"    bump: {peak/1e9:.1f} GB/rank > HBM; microbatches -> {mb}")
            cell = build_cell(arch, shape_name, mesh, smoke=smoke,
                              plan=cell.plan.override(microbatches=mb))
        mc = module_cost(gm)
        arg_bytes = sum(t.numel() * t.element_size() for t in fake_inputs)
        rec.update({
            "status": "ok",
            "kind": cell.kind,
            "microbatches": cell.plan.microbatches,
            "seq_shard": cell.plan.seq_shard,
            "fsdp": cell.plan.fsdp,
            "trace_s": round(time.time() - t0, 1),
            "bytes_per_device": int(peak),
            "arg_bytes": int(arg_bytes),
            "fits_hbm": bool(peak <= H100_SXM.hbm_bytes),
            "flops_per_dev": float(mc.flops),
            "kernel_calls": dict(mc.kernel_calls),
            "note": FAKE_NOTE,
        })
        if want_roofline:
            rep = roofline_report(
                arch=arch, shape=shape_name, mesh_desc=rec["mesh"], n_chips=n_ranks,
                cost=mc, model_flops_total=model_flops(cell.cfg, SHAPES[shape_name]),
                bytes_per_device=peak,
            )
            rec["roofline"] = {
                "hw": H100_SXM.describe(),
                "flops": rep.hlo_flops,
                "bytes": rep.hlo_bytes,
                "collective_bytes": rep.collective_bytes,
                "collectives": {k: [int(c), float(b)] for k, (c, b) in rep.collectives.items()},
                "compute_s": rep.compute_s,
                "memory_s": rep.memory_s,
                "collective_s": rep.collective_s,
                "bound_s": rep.step_time_bound(),
                "dominant": rep.dominant,
                "model_flops_total": rep.model_flops_total,
                "useful_ratio": rep.useful_ratio,
                "roofline_fraction": rep.roofline_fraction,
                "mfu_bound": rep.mfu_bound(),
                "note": rep.note,
            }
        if want_graphi:
            # a capture failure degrades to a per-cell note, never a failed cell
            try:
                rec["graphi"] = graphi_record(program, fake_inputs, f"{arch}.{shape_name}",
                                              runtime=runtime)
            except Exception as e:  # noqa: BLE001
                rec["graphi_error"] = f"{type(e).__name__}: {e}"
        del gm, fake_inputs
        if run:
            rec["run"] = run_rank_share(cell, dm, device)
    except Exception as e:  # noqa: BLE001
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["trace_s"] = round(time.time() - t0, 1)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    return rec


def summarize(records: list[dict]) -> str:
    rows = []
    for r in records:
        if r["status"] == "skip":
            rows.append(f"SKIP {r['arch']:22s} {r['shape']:12s} {r['mesh']:28s} "
                        f"({r['reason'][:40]}...)")
        elif r["status"] == "fail":
            rows.append(f"FAIL {r['arch']:22s} {r['shape']:12s} {r['mesh']:28s} "
                        f"{r['error'][:60]}")
        else:
            fit = "fits" if r["fits_hbm"] else "OVER"
            extra = ""
            if "roofline" in r:
                rf = r["roofline"]
                extra = (f" dom={rf['dominant'][:4]} c={rf['compute_s']*1e3:8.2f}ms"
                         f" m={rf['memory_s']*1e3:8.2f}ms x={rf['collective_s']*1e3:8.2f}ms"
                         f" useful={rf['useful_ratio']:.2f}")
            if "graphi" in r:
                gr = r["graphi"]
                extra += (f" graphi={gr['n_nodes']}n/w{gr['width']}"
                          f"/{gr['n_executors']}x{gr['team_size']}")
            if "run" in r:
                extra += (f" run={r['run']['run_peak_bytes']/1e9:.1f}GB"
                          f"/{r['run']['device_ms']:.1f}ms")
            rows.append(
                f"OK   {r['arch']:22s} {r['shape']:12s} {r['mesh']:28s} "
                f"{r['bytes_per_device']/1e9:6.1f}GB/rank {fit} mb={r['microbatches']}"
                f" {r['trace_s']:6.1f}s{extra}"
            )
    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"] == "skip")
    n_fail = sum(1 for r in records if r["status"] == "fail")
    rows.append(f"-- {n_ok} ok / {n_skip} skip / {n_fail} fail --")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default=None, help="one architecture id (default: all)")
    p.add_argument("--shape", default=None, help="one shape name (default: all)")
    p.add_argument("--mesh", choices=("pod", "multipod", "both"), default="both")
    p.add_argument("--smoke", action="store_true", help="the reduced configs (CPU-sized)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the rank's device (default: the card)")
    p.add_argument("--run", action="store_true",
                   help="also run rank 0's share once on the card")
    p.add_argument("--out", default="chiprun_out/dryrun.json")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--no-graphi", action="store_true",
                   help="skip the Graphi capture/schedule record per cell")
    args = p.parse_args(argv)

    from repro_torch.device import resolve_device

    device = str(resolve_device(args.device))
    if args.run and not device.startswith("cuda"):
        raise SystemExit("--run runs the rank's share on the card: drop --device cpu")
    archs = [args.arch] if args.arch else served_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if args.mesh in ("pod", "both"):
        meshes.append((make_production_mesh(), True))
    if args.mesh in ("multipod", "both"):
        meshes.append((make_production_mesh(multi_pod=True), False))

    # one Runtime for the whole sweep: every cell's Graphi record shares its
    # planning caches (sim backend — the executor pool stays unspawned)
    import repro_torch

    runtime = repro_torch.Runtime(device=device)
    repro_torch.set_default_runtime(runtime, torch.device(device).type)

    records = []
    for mesh, want_roofline in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh, want_roofline=want_roofline,
                               want_graphi=not args.no_graphi, run=args.run,
                               smoke=args.smoke, device=device,
                               verbose=args.verbose, runtime=runtime)
                records.append(rec)
                print(summarize([rec]).splitlines()[0], flush=True)
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
    runtime.close()

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    print(summarize(records).splitlines()[-1])
    return 1 if any(r["status"] == "fail" for r in records) else 0


if __name__ == "__main__":
    raise SystemExit(main())
