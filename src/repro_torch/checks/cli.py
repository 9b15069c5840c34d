"""``python -m repro_torch.checks`` — the static-verification sweep.

Default run: source rules (W-ASSERT) plus a live segment-FIFO probe (two
static plans replayed concurrently on one pool of the device's executors,
journal replayed through E-FIFO).  ``--zoo`` adds the config-zoo model
sweep: for every arch, capture the lm_loss, prefill, and decode graphs
(plus the paged decode / chunk-prefill pair where supported) on the device,
then run every structural checker and the hazard analysis over graph,
schedule, and compiled host plan.  ``--device cpu`` runs on the CPU; the
card is the default.  Exit status 1 when any error-severity finding
survives.

:func:`verify_engine` runs the same checks over a live serving engine's
captured executables (the serving CLI's ``--check``).
"""
from __future__ import annotations

import argparse
import threading
from typing import Any, Iterable

import torch
from torch.utils import _pytree as pytree

from . import verify_all
from .assertscan import scan_asserts
from .effects import infer_effects, shared_buffers
from .hazards import cross_graph_hazards
from .invariants import check_segment_fifo, segment_queues
from .report import Report

__all__ = ["main", "paged_binds", "paged_pair_report", "run_fifo_probe", "run_zoo_arch",
           "verify_engine"]

# zoo capture shape — small enough that the archs sweep in minutes, deep
# enough (2 smoke layers, real vocab padding) that fusion, the per-layer
# loops, and cache scatters all appear in the captured graphs
_B, _SEQ, _MAX_LEN, _PAGE = 2, 16, 32, 8
_N_WORKERS = 8


def run_fifo_probe(*, runs: int = 6, device: str | torch.device = "cuda") -> Report:
    """Replay two static plans concurrently on one journaled pool and verify
    segment-submission FIFO consistency from the evidence."""
    import repro_torch
    from repro_torch.core.engine import ExecutorPool
    from repro_torch.core.static_host import layered_graph
    from repro_torch.runtime import Runtime

    g = layered_graph(3, 2)
    with Runtime(4, device=device) as rt:
        exe = repro_torch.compile(g, n_executors=2, team_size=2, runtime=rt)
        plan = exe.host_plan(2)
    pool = ExecutorPool(2, device=rt.device)
    pool.segment_log = []
    try:
        def worker() -> None:
            for _ in range(runs):
                plan.run({"x": 1.0}, pool=pool)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        pool.close()
    return check_segment_fifo(segment_queues(pool.segment_log))


def _check_executable(exe: Any, label: str) -> Report:
    rep = verify_all(exe.graph, exe.schedule, exe.host_plan())
    return rep.scoped(label)


def paged_pair_report(dec: Any, chunk: Any, bind_d: dict, bind_c: dict,
                      pool_leaves: Iterable[torch.Tensor], where: str) -> Report:
    """The paged decode step × prefill chunk certification.

    The decode step scatters into the page pools; every chunk prefill must
    be read-only over them (the engine's concurrency protocol: a chunk runs
    beside a decode step, and its K/V is inserted after) — certified from
    the captured fx nodes, not assumed.  ``bind_d`` / ``bind_c`` are the two
    graphs' bound inputs over the *same* pool tensor objects
    (``pool_leaves``)."""
    rep = Report()
    eff_d = infer_effects(dec.graph)
    eff_c = infer_effects(chunk.graph)
    shared = shared_buffers(bind_d, bind_c)
    pool_ids = {id(x) for x in pool_leaves}
    pool_shared = [(a, b) for a, b in shared if id(bind_d[a]) in pool_ids]
    if not pool_shared:
        rep.add("H-XWW", "error",
                "paged decode and prefill chunk share no pool buffers — "
                "alias discovery broke", where=where)
    unwritten = sorted({a for a, _ in pool_shared} - eff_d.written())
    if unwritten:
        rep.add("H-XWW", "error",
                f"paged decode writes {len(unwritten)} of {len(pool_shared)} pool "
                f"buffer(s) nowhere (first {unwritten[0]!r}) — effect inference "
                "lost the pool scatters", where=where)
    rep.extend(cross_graph_hazards(eff_d, eff_c, shared))
    if eff_c.read_only(b for _, b in pool_shared):
        rep.add("C-RO", "info",
                f"prefill chunk certified read-only over {len(pool_shared)} "
                "shared pool buffer(s)", where=where)
    return rep


def paged_binds(dec: Any, chunk: Any, params: Any, pages: Any, *, rows: int,
                n_pt: int, chunk_len: int, device: torch.device) -> tuple[dict, dict]:
    """Both paged graphs bound to one ``pages`` object (the other inputs
    only need the captured structure)."""
    i32 = {"dtype": torch.int32, "device": device}
    cache = {"len": torch.zeros((rows,), **i32),
             "table": torch.full((rows, n_pt), -1, **i32),
             "pages": pages}
    bind_d = dec.captured.bind((params, cache, torch.zeros((rows, 1), **i32)))
    bind_c = chunk.captured.bind(
        (params, pages, torch.full((n_pt,), -1, **i32),
         {"tokens": torch.zeros((1, chunk_len), **i32)},
         torch.tensor(0, **i32), torch.tensor(chunk_len, **i32)))
    return bind_d, bind_c


def verify_engine(engine: Any) -> Report:
    """Verify a serving engine's captured executables: graph, schedule,
    host plan and hazards of its decode graph (and of its chunk-prefill
    graph), and, for the paged engine, the decode × chunk pair over the
    engine's one set of pool tensors."""
    rep = Report()
    chunk = getattr(engine, "_chunk_exe", None)
    for exe in [engine._decode_exe] + ([chunk] if chunk is not None else []):
        rep.extend(exe.verify(hazards=True).scoped(exe.graph.name))
    if chunk is not None:
        bind_d, bind_c = paged_binds(
            engine._decode_exe, chunk, engine.params, engine._pages,
            rows=engine.capacity, n_pt=engine.n_pt, chunk_len=engine.chunk,
            device=engine.device)
        rep.extend(paged_pair_report(
            engine._decode_exe, chunk, bind_d, bind_c,
            pytree.tree_leaves(engine._pages),
            where=f"{engine._decode_exe.graph.name}×{chunk.graph.name}"))
    return rep


def run_zoo_arch(arch: str, *, device: str | torch.device = "cuda") -> Report:
    """Capture and verify one arch's graphs (lm_loss; prefill and decode
    where :func:`~repro_torch.models.transformer.serving_supported`; the
    paged pair where :func:`~repro_torch.models.transformer.paged_supported`)."""
    import repro_torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import (make_decode_step, make_paged_decode_step,
                                        make_prefill_chunk_step, make_prefill_step)
    from repro_torch.train.step import compile_lm_loss

    dev = resolve_device(device)
    rep = Report()
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec("check", _SEQ, _B, "train")
    params = transformer.init_params(cfg, 0, device=dev)
    i32 = {"dtype": torch.int32, "device": dev}
    rt = Runtime(_N_WORKERS, device=dev)

    def guarded(label: str, build) -> None:
        try:
            rep.extend(build())
        except Exception as e:  # noqa: BLE001 — one bad graph must not hide the rest
            rep.add("Z-SKIP", "warning",
                    f"{type(e).__name__}: {e}", where=f"{arch}/{label}")

    def loss() -> Report:
        exe = compile_lm_loss(cfg, shape, backend="host", runtime=rt, device=dev)
        return _check_executable(exe, f"{arch}/lm_loss")

    def prefill() -> Report:
        cache = transformer.init_cache(cfg, _B, _MAX_LEN, device=dev)
        specs = model_api.input_specs(cfg, shape, kind="prefill", device=dev)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in specs.items()}
        exe = repro_torch.compile(make_prefill_step(cfg), params, cache, batch,
                                  runtime=rt, name=f"{arch}.prefill")
        return _check_executable(exe, f"{arch}/prefill")

    def decode() -> Report:
        cache = transformer.init_cache(cfg, _B, _MAX_LEN, device=dev)
        tok = torch.zeros((_B, 1), **i32)
        exe = repro_torch.compile(make_decode_step(cfg), params, cache, tok,
                                  runtime=rt, name=f"{arch}.decode")
        return _check_executable(exe, f"{arch}/decode")

    def paged() -> Report:
        n_pt = _MAX_LEN // _PAGE
        pages = transformer.init_paged_cache(
            cfg, _B, _MAX_LEN, n_pages=_B * n_pt, page_size=_PAGE,
            device=dev)["pages"]          # ONE pool object for both graphs
        cache_spec = {"len": torch.zeros((_B,), **i32),
                      "table": torch.full((_B, n_pt), -1, **i32),
                      "pages": pages}
        dec = repro_torch.compile(
            make_paged_decode_step(cfg, _PAGE), params, cache_spec,
            torch.zeros((_B, 1), **i32), runtime=rt, name=f"{arch}.paged_decode")
        chunk = repro_torch.compile(
            make_prefill_chunk_step(cfg, _PAGE), params, pages,
            torch.full((n_pt,), -1, **i32), {"tokens": torch.zeros((1, _PAGE), **i32)},
            torch.tensor(0, **i32), torch.tensor(_PAGE, **i32),
            runtime=rt, name=f"{arch}.prefill_chunk")
        sub = _check_executable(dec, f"{arch}/paged_decode")
        sub.extend(_check_executable(chunk, f"{arch}/prefill_chunk"))
        bind_d, bind_c = paged_binds(dec, chunk, params, pages, rows=_B, n_pt=n_pt,
                                      chunk_len=_PAGE, device=dev)
        sub.extend(paged_pair_report(dec, chunk, bind_d, bind_c,
                                     pytree.tree_leaves(pages), where=f"{arch}/paged"))
        return sub

    try:
        guarded("lm_loss", loss)
        if transformer.serving_supported(cfg):
            guarded("prefill", prefill)
            guarded("decode", decode)
        if transformer.paged_supported(cfg):
            guarded("paged", paged)
    finally:
        rt.close()
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.checks",
        description="static verifier: structural invariants, effect/hazard "
                    "analysis, source rules",
    )
    ap.add_argument("--zoo", action="store_true",
                    help="capture and verify the config-zoo model graphs")
    ap.add_argument("--arch", action="append", default=None,
                    help="restrict --zoo to this arch (repeatable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the graphs are captured and the FIFO probe "
                         "runs (default: the card)")
    ap.add_argument("--no-asserts", action="store_true",
                    help="skip the W-ASSERT source scan")
    ap.add_argument("--no-fifo", action="store_true",
                    help="skip the live segment-FIFO probe")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show info-severity findings")
    args = ap.parse_args(argv)

    total = Report()
    if not args.no_asserts:
        asserts = scan_asserts()
        total.extend(asserts)
        print(f"asserts : {asserts.summary()}")
    if not args.no_fifo:
        fifo = run_fifo_probe(device=args.device)
        total.extend(fifo)
        print(f"fifo    : {fifo.summary()}")
    if args.zoo or args.arch:
        from repro_torch.configs.base import list_archs

        archs = args.arch or [a.replace("_", "-") for a in list_archs()]
        for arch in archs:
            rep = run_zoo_arch(arch, device=args.device)
            total.extend(rep)
            print(f"{arch:22s}: {rep.summary()}")

    min_sev = "info" if args.verbose else "warning"
    body = total.render(min_severity=min_sev)
    if body != "clean: no findings" or args.verbose:
        print()
        print(body)
    print()
    print(f"TOTAL   : {total.summary()}")
    return 0 if total.ok else 1
