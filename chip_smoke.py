#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py [--layers N] [--out DIR]

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
the JAX package).  Phases, each of which exits non-zero on failure:

1. device  — a CUDA device must exist; prints the card's name and power limit;
2. build   — compiles every kernel from its source into ``build/kernels/``;
3. kernels — runs each kernel against its plain PyTorch version on the card
   at the shapes the serve phase gives it (gemma-2b paged decode: B=8,
   Hq=8, Hkv=1, hd=256, ps=16, n_pt=64, bf16) and times both;
4. small   — the smoke gemma-2b config in f32: one captured decode step on
   the card against the eager step on the CPU (plain attention);
5. serve   — full-width gemma-2b (random weights from a seed) served through
   ``repro_torch.serve_engine(..., paged=PagedConfig(...))``: 8 greedy
   requests, two sharing a prefix; checks the streams, the kernel's launch
   count on this run, and one decode step run three ways (static plan,
   dynamic scheduler, sequential ``Graph.execute``) for identical logits.

It prints one ``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  ``--out`` also writes the numbers to
``DIR/chip_smoke.json``.
"""
import os

# deterministic cuBLAS workspaces per stream: the three-way decode check
# compares logits bit for bit across executor streams
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12             # H100 SXM published dense bf16 rate
KERNEL_TOL = 3e-2               # bf16: the two paths round at other places
SMALL_TOL = 1e-4                # f32, CPU vs card: sums in another order


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernels ----------------------------------------------------------

def paged_case(torch, *, B=8, Hq=8, Hkv=1, hd=256, ps=16, n_pt=64, seed=0):
    """gemma-2b decode shapes: mixed lengths, an idle row (7), rows 3 and 4
    sharing their first 20 pages.  Returns tensors on the card and the live
    row mask."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = B * n_pt
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").bfloat16()
    lengths = [1024, 37, 512, 700, 333, 129, 1000, 0]
    perm = torch.randperm(P, generator=gen, device="cuda").tolist()
    table = torch.full((B, n_pt), -1, dtype=torch.int32)
    q_pos = torch.zeros((B,), dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[b, j] = perm[nxt]
            nxt += 1
        q_pos[b] = max(n - 1, 0)
    table[4, :20] = table[3, :20]
    live = torch.tensor([n > 0 for n in lengths], device="cuda")
    return q, k, v, table.cuda(), q_pos.cuda(), live


def paged_bound_ms(q, k, table, q_pos, live, window) -> tuple[float, str]:
    """Least time for this call's work: the K/V pages its live rows need
    (each distinct page read once), q, table, q_pos and the output, over
    the HBM rate; or its flops over the bf16 rate, whichever is larger."""
    _, ps, Hkv, hd = k.shape
    B, Hq, _ = q.shape
    pages, entries = set(), 0
    tab, qp = table.cpu().tolist(), q_pos.cpu().tolist()
    for b in range(B):
        if not bool(live[b]):
            continue
        lo = 0 if window is None else max(0, qp[b] - window + 1)
        for j in range(lo // ps, qp[b] // ps + 1):
            if tab[b][j] >= 0:
                pages.add(tab[b][j])
        entries += qp[b] + 1 - lo
    kv = 2 * len(pages) * ps * Hkv * hd * k.element_size()
    io = 2 * q.numel() * q.element_size() + table.numel() * 4 + q_pos.numel() * 4
    flops = 4.0 * entries * Hq * hd
    t_bytes, t_ops = (kv + io) / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch) -> dict:
    from repro_torch.kernels.decode_attention import (paged_decode_attention_cuda,
                                                      paged_decode_attention_plain)

    q, k, v, table, q_pos, live = paged_case(torch)
    rows = {}
    for window in (None, 256):
        out = paged_decode_attention_cuda(q, k, v, table, q_pos, window)
        ref = paged_decode_attention_plain(q, k, v, table, q_pos, window)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"paged kernel (window={window}) wrote non-finite values")
        err = (out[live].float() - ref[live].float()).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"paged kernel (window={window}) max abs err {err} > {KERNEL_TOL}")
        ms = cuda_ms(lambda w=window: paged_decode_attention_cuda(q, k, v, table, q_pos, w), 200)
        plain_ms = cuda_ms(lambda w=window: paged_decode_attention_plain(
            q, k, v, table, q_pos, w), 50)
        bound_ms, bound_by = paged_bound_ms(q, k, table, q_pos, live, window)
        rows[window] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"kernel paged_decode_attention window={window}: max_abs_err={err:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
    return rows


# -- phase 4: small reference --------------------------------------------------

def small_phase(torch) -> None:
    import numpy as np
    from torch.utils import _pytree as pytree

    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.step import make_paged_decode_step

    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32)
    cpu = transformer.init_params(cfg, 0, device="cpu")
    gpu = pytree.tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(0)
    B, ps, n_pt, P = 4, 8, 8, 32
    pages = [{kk: torch.as_tensor(rng.standard_normal((P, ps, 1, cfg.resolved_head_dim)),
                                  dtype=torch.float32) for kk in ("k", "v")}
             for _ in range(cfg.n_layers)]
    table = np.full((B, n_pt), -1, np.int32)
    table[0, :3], table[1, :1], table[2, :5] = [1, 2, 3], [9], [4, 5, 6, 7, 8]
    cache = {"len": torch.tensor([20, 3, 36, 0], dtype=torch.int32),
             "table": torch.as_tensor(table), "pages": pages}
    tokens = torch.tensor([[5], [17], [300], [0]], dtype=torch.int32)
    step = make_paged_decode_step(cfg, ps)
    ref_logits, ref_cache = step(cpu, cache, tokens)
    gcache = pytree.tree_map(lambda t: t.cuda(), cache)
    with Runtime(device="cuda") as rt:
        exe = rt_compile(step, gpu, gcache, tokens.cuda(), runtime=rt, jit_nodes=True,
                         host_mode="static")
        logits, new_cache = exe(gpu, gcache, tokens.cuda())
    live = slice(0, 3)
    err = (logits.cpu()[live] - ref_logits[live]).abs().max().item()
    if not (logits.shape == ref_logits.shape and torch.isfinite(logits).all() and err <= SMALL_TOL):
        fail(f"small decode step on the card disagrees with the CPU: max abs err {err}")
    for a, b in zip(new_cache["pages"], ref_cache["pages"]):
        if not torch.allclose(a["k"].cpu(), b["k"], atol=SMALL_TOL):
            fail("small decode step wrote other K pages on the card than on the CPU")
    log(f"small: smoke gemma-2b f32 decode step, card vs CPU max abs err {err:.3e}")


# -- phase 5: serve ------------------------------------------------------------

def serve_phase(torch, n_layers: int) -> dict:
    import numpy as np
    from torch.utils import _pytree as pytree

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import paged_decode_attention_cuda
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, Request, ServeConfig

    cfg = get_config("gemma-2b")
    if n_layers != cfg.n_layers:
        log(f"serve: depth cut from {cfg.n_layers} to {n_layers} layers")
        cfg = cfg.reduced(n_layers=n_layers)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    log(f"serve: gemma-2b {cfg.n_layers}x{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"hd {cfg.resolved_head_dim} ff {cfg.d_ff} vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f}B params in {time.perf_counter() - t0:.1f}s")

    rt = Runtime(device="cuda")
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(
        cfg, params, ServeConfig(max_batch=8, max_len=1024),
        paged=PagedConfig(page_size=16, prefill_chunk=128), device="cuda", runtime=rt)
    setup_s = time.perf_counter() - t0
    log(f"serve: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
        f"n_executors={eng.n_executors} team_size={eng.profile.best_team_size} "
        f"decode_host_mode={eng.decode_host_mode} decode nodes={len(eng._decode_exe.graph)}")

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    prefix = rng.integers(1, V, 128)
    tail = rng.integers(1, V, 40)
    shared_a = np.concatenate([prefix, tail])                       # 168 tokens
    shared_b = np.concatenate([prefix, tail[:5], rng.integers(1, V, 60)])  # diverges mid-page
    others = [rng.integers(1, V, n) for n in (64, 512, 200, 333, 97, 450)]
    new_tokens = 32

    paged_decode_attention_cuda.launches = 0      # count the main path's launches only
    t_serve = time.perf_counter()
    eng.submit(Request(0, shared_a.astype(np.int32), max_new_tokens=new_tokens))
    while eng.prefills or eng.pending:            # request 0's prefix registers first
        eng.step()
    for i, p in enumerate([shared_b] + others, start=1):
        eng.submit(Request(i, p.astype(np.int32), max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = paged_decode_attention_cuda.launches

    if len(done) != 8 or any(not r.done or len(r.output) != new_tokens for r in done):
        fail(f"serve: {len(done)} requests came back, not 8 complete ones")
    if any(not (0 <= t < V) for r in done for t in r.output):
        fail("serve: a token id outside the vocabulary")
    st = eng.stats()
    if st["n_shared_pages"] < 8 or st["n_cow_copies"] < 1:
        fail(f"serve: prefix sharing did not happen ({st})")
    need = cfg.n_layers * st["n_decode_steps"]
    if launches < need:
        fail(f"serve: paged kernel launched {launches} times, < {need} "
             f"({cfg.n_layers} layers x {st['n_decode_steps']} decode steps)")
    n_tok = sum(len(r.output) for r in done)
    p50 = statistics.median(eng.decode_step_s)
    log(f"serve: {len(done)} requests, {n_tok} tokens in {wall:.2f}s = {n_tok / wall:.1f} tok/s; "
        f"decode step p50 {1e3 * p50:.1f} ms over {st['n_decode_steps']} steps; "
        f"paged kernel launches {launches}; {json.dumps(st)}")
    log(f"serve: first tokens {[r.output[:4] for r in done]}")

    three, inputs = three_way_decode(torch, eng, rng)
    trace = profile_decode(torch, eng, inputs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve: peak device memory {peak_gb:.2f} GB")
    rt.close()
    return {"trace": trace, "peak_mem_gb": peak_gb,"launches": launches, "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "decode_p50_ms": 1e3 * p50, "n_decode_steps": st["n_decode_steps"],
            "n_executors": eng.n_executors, "team_size": eng.profile.best_team_size,
            "peak_pages": st["peak_pages"], "stats": st, "setup_s": eng.setup_s,
            "engine_build_s": setup_s, "three_way": three}


def three_way_decode(torch, eng, rng) -> dict:
    """One decode step over the pools the run left behind, as a static plan,
    under the dynamic scheduler and through sequential ``Graph.execute``:
    the logits must be identical bit for bit."""
    import numpy as np

    exe = eng._decode_exe
    B, n_pt = eng.capacity, eng.n_pt
    lens = np.array([1000, 17, 300, 640, 64, 129, 2, 0], np.int32)
    perm = rng.permutation(eng.page_pool.n_pages)
    table = np.full((B, n_pt), -1, np.int32)
    at = 0
    for b, n in enumerate(lens):
        m = -(-(n + 1) // eng.pcfg.page_size) if n else 0
        table[b, :m] = perm[at:at + m]
        at += m
    tokens = rng.integers(1, eng.cfg.vocab_size, (B, 1)).astype(np.int32)
    args = (eng.params, {"len": eng._dev(lens), "table": eng._dev(table), "pages": eng._pages},
            eng._dev(tokens))
    inputs = exe.captured.bind(args)
    out = {}
    t = {}
    for mode in ("static", "dynamic"):
        t0 = time.perf_counter()
        res = exe.execute_host(inputs, n_executors=eng.n_executors, host_mode=mode)
        out[mode] = exe.captured.unflatten(res.outputs)[0]
        torch.cuda.synchronize()
        t[mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sequential"] = exe.captured.unflatten(exe.graph.execute(inputs))[0]
    torch.cuda.synchronize()
    t["sequential"] = time.perf_counter() - t0
    ref = out["sequential"]
    if tuple(ref.shape) != (B, eng.cfg.padded_vocab) or not torch.isfinite(ref).all():
        fail(f"three-way decode: logits {tuple(ref.shape)} not finite [B, vocab]")
    for mode in ("static", "dynamic"):
        if not torch.equal(out[mode], ref):
            diff = (out[mode] - ref).abs().max().item()
            fail(f"three-way decode: {mode} logits differ from sequential (max {diff})")
    log("three-way decode: static, dynamic and sequential logits identical; host s "
        + json.dumps({k: round(v, 4) for k, v in t.items()}))
    return {"identical": True, "host_s": t}, inputs


def profile_decode(torch, eng, inputs, steps: int = 3) -> dict:
    """Where one decode step's time goes: ``torch.profiler`` over a few
    static-plan decode steps.  Device busy time is the union of the CUDA
    kernel intervals (streams may overlap); its share of the host wall time
    is what the card was busy.  Reports "not measured" if the profiler
    sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    exe = eng._decode_exe
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            exe.execute_host(inputs, n_executors=eng.n_executors, host_mode="static")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if not spans:
        log("profile: no device events recorded (device busy share not measured)")
        return {"measured": False}
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == cuda:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total_kernel = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"measured": True, "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3, "busy_share": busy / wall_us,
           "kernel_ms_per_step": total_kernel / steps / 1e3, "n_kernels": len(spans) // steps,
           "top": [(name[:80], ms / steps / 1e3) for name, ms in top]}
    log(f"profile: decode step wall {out['wall_ms_per_step']:.2f} ms, device busy "
        f"{out['device_busy_ms_per_step']:.2f} ms ({100 * out['busy_share']:.1f}%), "
        f"{out['n_kernels']} kernels/step")
    for name, ms in out["top"]:
        log(f"profile:   {ms:8.3f} ms/step  {name}")
    return out


def _parse() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=18,
                    help="gemma-2b depth for the serve phase (full: 18)")
    ap.add_argument("--out", default=None, help="directory for chip_smoke.json")
    return ap.parse_args()


def main() -> None:
    args = _parse()
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    # phase 2: build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    log(f"build: {len(built)} kernel(s) in {time.perf_counter() - t0:.1f}s into {_build.build_dir()}")
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"build: {name}: {' | '.join(ptxas[:6])}")

    # phase 3: kernels against their plain versions
    kern = kernel_phase(torch)
    # phase 4: a small input against the CPU reference
    small_phase(torch)
    # phase 5: serve full-width gemma-2b
    serve = serve_phase(torch, args.layers)

    main_row = kern[None]
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:193",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": kernels, "kernel_rows": {str(k): v for k, v in kern.items()},
             "serve": serve, "total_s": time.perf_counter() - t_all}, indent=1, default=str))
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
