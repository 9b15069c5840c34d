"""Quickstart on the PyTorch port: ``repro_torch.Runtime`` — any PyTorch
function becomes a scheduled Graphi graph on the process-wide runtime.  The
twin of ``examples/quickstart.py``.

Builds the one :class:`repro_torch.Runtime` a process needs (it owns the
single executor pool, the calibration store and admission; on the card its
executors are CUDA streams), compiles a plain PyTorch function (four
parallel matrix-product branches + a combine) into an operator DAG,
inspects the profile and the critical-path-first schedule, executes it
with the host runtime (the run leases its executors from the runtime),
and checks the result against calling the function directly.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core.trace import ascii_timeline


def f(x, w):
    """4 independent branches -> combine -> scalar loss (width-4 DAG)."""
    branches = [torch.tanh(x @ (w * (0.1 * (i + 1)))) for i in range(4)]
    y = sum(branches)
    return torch.sum(y * y)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(256, 256)), dtype=torch.float32, device=args.device)
    w = torch.as_tensor(rng.normal(size=(256, 256)), dtype=torch.float32, device=args.device)

    hw = repro_torch.H100 if x.is_cuda else repro_torch.KNL7250
    rt = repro_torch.Runtime(hw=hw, device=args.device)     # the process-wide session
    print(f"runtime: {rt.describe()}")
    exe = rt.compile(f, x, w)
    g = exe.graph
    print(f"captured: {g}")
    print(f"nodes: {g.names}")

    prof = exe.profile
    print(f"profiler: best config = {prof.best_n_executors} executors "
          f"x {prof.best_team_size} cores, makespan {prof.best_makespan * 1e6:.1f} us")
    sched = exe.schedule
    print("CPF schedule (modelled):")
    print(ascii_timeline(
        [type("E", (), {"op": n, "executor": e, "start": s, "end": t})()
         for n, (e, s, t) in sched.placements.items()],
        sched.n_executors, width=72))
    cp_len, cp = exe.critical_path
    print(f"critical path ({cp_len * 1e6:.1f} us): {' -> '.join(cp)}")

    out = exe(x, w)                       # host backend: leased parallel run
    ref = f(x, w)                         # the function called directly
    err = float((out - ref).abs() / ref.abs())
    used = len({e.executor for e in exe.last_run.trace})
    print(f"host parallel run == direct call: rel err={err:.2e} "
          f"({'OK' if err < 1e-5 else 'MISMATCH'}), {used} executors used "
          f"(leased from {rt.n_workers}-worker pool)")
    rt.close()
    return err


if __name__ == "__main__":
    main()
