#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py [--layers N] [--out DIR]

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
the JAX package).  Phases, each of which exits non-zero on failure:

1. device  — a CUDA device must exist; prints the card's name and power limit;
2. build   — compiles every kernel from its source into ``build/kernels/``
   (one ``nvcc`` per source, all started together);
3. kernels — runs each kernel against its plain PyTorch version on the card
   at the shapes the LSTM and serve phases give it, and times the kernel,
   the plain version and (where one exists) one PyTorch library call for
   the same function: B1 paged decode (B=8, Hq=8, Hkv=1, hd=256, ps=16,
   n_pt=64), B2 dense decode in both forms (B=8, C=1024), B3 flash
   attention (B=1, S in {333, 512}, causal), each with and without a
   256-token window, bf16, and B1 / B2 / B3 once more at granite's
   attention shape (Hq=16, Hkv=8, hd=64), B2 at h2o-danube3-4b's (32 / 8
   heads of 120), B3 at olmoe's (16 heads of 128) and on a 2048-token
   gemma prompt (its 64-row tile form); every row compared, idle rows
   included; B1, B2 and B3 called twice for the same bits, B1 and B2 one
   kernel a call under ``torch.profiler``, B1 also timed as B2 over a dense
   cache holding the same entries (the gather's cost), each B1 / B2 row
   with the cluster size and chunk its launch takes; B4 LSTM cell (N=64 and
   256, H=1024, f32; bf16 gates with f32 state; a ragged N=37, H=200); B5
   grouped expert matmul at granite's expert shapes (E=32, D x F = 1024 x
   512 and 512 x 1024, C in {8, 40, 104, 256, 416}, bf16; C=104 in f32; a
   ragged E=3, C=37, D=200, F=72), its weights cycled through four copies
   so each call reads them from device memory; B6 selective scan at
   falcon-mamba-7b's shapes (prefill B=1, S=333, D=8192, St=16 from zero;
   decode B=8, S=1 from a state; ragged B=2, S=37, D=200; the reference's
   state-carry case) and B7 RG-LRU scan at recurrentgemma-2b's (prefill
   B=1, S=333, R=2560; decode B=8, S=1; ragged R=200, S=37), f32 math, c in
   the model's bf16 on the serving shapes; the backward kernels: B3's at
   gemma-2b's training shape (B=4, S=512, 8 / 1 heads of 256, bf16; its
   tensor-core form), with a 256-token window, and in f32 at the small
   train step's shape (its SIMT form; its training forward's log-sum-exp
   and output too; yardstick SDPA forward + backward against B3's forward
   + backward), also at granite-moe-1b-a400m's (16 / 8 heads of 64) and
   recurrentgemma-2b's (10 / 1 heads of 256) training widths, B4's at
   N=64, H=1024 (f32; bf16 gates; yardstick
   ``aten._thnn_fused_lstm_cell_backward_impl``); the backwards of B5, B6
   and B7 at their training paths' shapes (B5-bwd at granite's E=32,
   C=640, D x F = 1024 x 512 and 512 x 1024, bf16 on the tensor cores,
   beside ``torch.bmm`` for dX and for dW; B6-bwd at falcon-mamba's B=4,
   S=512, D=8192, St=16 with c in bf16; B7-bwd at recurrentgemma's B=4,
   S=512, R=2560), at the small train phase's f32 smoke shapes and at
   ragged ones, B6's da / db / dh0 and all of B7's bit-equal to their
   plain versions;
   every gradient element compared, the same bits on two calls;
4. small   — the smoke gemma-2b, granite-moe-1b-a400m, falcon-mamba-7b and
   recurrentgemma-2b configs in f32: one captured paged decode step (the
   attention archs), one captured per-slot prefill and one captured
   per-slot decode step each on the card against the eager steps on the
   CPU, every row compared (recurrentgemma's prompt is longer than its
   16-token window, so the ring cache wraps), every B3 / B5 launch on the
   SIMT form; and a small
   LSTM (L=2, T=5, B=4, H=64) captured and run on the card, sequential and
   stacked, against the eager CPU run; then the smoke gemma-2b's,
   granite-moe-1b-a400m's, falcon-mamba-7b's and recurrentgemma-2b's loss
   (and MoE aux) and gradients (f32) on the card against the CPU within
   1e-4, each training kernel's launches exact and on its SIMT form, one
   train step, and each loss + gradient graph
   (``compile_lm_loss(grad=True)``) run as a static plan, dynamically and
   sequentially, bit-identical and equal to eager autograd;
5. lstm    — the paper's Table 1 "large" LSTM at its published size (4
   layers x 40 steps, batch 64, 1024 neurons, f32, random weights from a
   seed): the CPF wavefront checks in the simulator under the H100 model;
   eager ``sequential_lstm`` and ``stacked_wavefront_lstm`` on the card;
   the sequential LSTM captured into its 4 x 40 cell graph and run by
   ``repro_torch.compile`` on the card's stream executors (static plan,
   dynamic scheduler and sequential ``Graph.execute`` bit-identical); and
   the mean dispatch time per anti-diagonal on the card (B4 on every path);
   and the gradient of a mean squared error through the sequential and
   stacked plans (B4's backward kernel), stacked within 1e-4 of
   sequential, B4 forward / backward launched 160 / 160 and 43 / 43 times;
6. train   — full-width gemma-2b (2.5 B parameters, random weights from
   seed 0) through ``make_train_step`` and the ``Trainer``: 3 AdamW steps
   on the bigram stream at B=4, S=512, remat on, every loss and gradient
   norm finite, B3's training forward launched 2 x 18 and its backward 18
   times a step (all on the tensor cores; the small f32 train step's on
   the SIMT forms), ms/step p50, tokens/s and peak memory; the trainer's
   checkpoint of the last step restored bit for bit; then, each freed
   before the next is built, full-width granite-moe-1b-a400m (24 layers,
   32 experts top-8) and recurrentgemma-2b (18 RG-LRU + 8 local-MQA
   layers) and falcon-mamba-7b at FALCON_TRAIN_LAYERS of its 64 layers,
   3 AdamW steps each at B=4, S=512 with remat: losses, MoE aux and
   gradient norms finite, the MoE loss = ce + 0.01 aux, per step exactly
   2 forward launches and 1 backward a layer of B3, B5 (three products a
   layer), B6 and B7 and none of any other kernel, B3 / B5 all on the
   tensor cores; ms/step p50, tokens/s, peak memory and a profiled step;
7. serve   — full-width gemma-2b (random weights from a seed) through three
   engines, each with the kernels' launch counts set to 0 just before and
   read just after:
   * paged: ``serve_engine(..., paged=PagedConfig(...))``, 8 greedy
     requests, two sharing a prefix (B1);
   * slot: ``serve_engine(...)`` (the per-slot ContinuousEngine), 8 greedy
     requests of 64-512 tokens submitted 4 + 4 so admissions overlap decode
     steps (B2 per-row form, B3);
   * wave: ``serve_engine(..., continuous=False)``, two length buckets
     (B2 shared form, B3);
   the paged and slot engines also run one decode step three ways (static
   plan, dynamic scheduler, sequential ``Graph.execute``) for identical
   logits and profile a few decode steps (the slot engine also one
   512-token prefill);
8. moe     — full-width granite-moe-1b-a400m (24 layers, 32 experts top-8,
   random weights from seed 0; gemma's freed first) through the same three
   engines, 8 greedy requests of 4 x 200 and 4 x 333 prompt tokens and 16
   new tokens, two sharing a 128-token prefix; slot admissions 4 + 4.
   Every model call launches B5 three times per layer, and the count is
   checked exactly; the paged and slot engines run the three-way decode
   check and profile a few decode steps;
9. recurrent — full-width falcon-mamba-7b (64 Mamba layers, 7.27 B
   parameters), then full-width recurrentgemma-2b (26 layers: 18 RG-LRU, 8
   local attention), random weights from seed 0, the previous model freed
   first, each through the slot and wave engines: 8 greedy requests of 4 x
   200 and 4 x 333 prompt tokens, 16 new tokens each, slot admissions 4 +
   4.  Every model call launches B6 once per Mamba layer and B7 once per
   RG-LRU layer (B2 / B3 once per attention layer), checked exactly; the
   slot engine runs the three-way decode check and profiles a few decode
   steps; ``serve_engine(..., paged=PagedConfig(...))`` must refuse both.

Every B3 and B5 launch of the full-width serve phases must take the
tensor-core form (``launches_by_path["mma"]``).  It prints one
``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  ``--out`` also writes the numbers to
``DIR/chip_smoke.json``.
"""
import os

# deterministic cuBLAS workspaces per stream: the three-way decode check
# compares logits bit for bit across executor streams
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12             # H100 SXM published dense bf16 rate
F32_FLOPS = 67e12               # H100 SXM published f32 rate outside the tensor cores
KERNEL_TOL = 3e-2               # bf16: the two paths round at other places
F32_KERNEL_TOL = 2e-5           # f32 kernels: the same math, other instruction order
SMALL_TOL = 1e-4                # f32, CPU vs card: sums in another order
LSTM_TOL = 1e-4                 # f32, stacked bmm vs per-layer mm over K=1024


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


# timings taken with CUDA events because torch.profiler saw no device time
EVENT_TIMED: list[int] = []
# timings whose every profiler window recorded fewer kernels than launches
SCALED: list[int] = []


def launches_and_kernels(torch, events) -> tuple[int, int]:
    """Kernel launches (``cudaLaunch*`` / ``cuLaunch*`` runtime calls) that
    the profiler recorded on the host, and kernels it recorded on the
    device.  It can drop a short kernel's device record (seen on an H100:
    7 records for 8 launches of a ~2 µs kernel), never its launch."""
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum(1 for e in events if e.device_type != cuda
                   and e.name.startswith(("cudaLaunch", "cuLaunch")))
    kernels = sum(1 for e in events if e.device_type == cuda
                  and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    return launches, kernels


def device_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Device time of one call: the CUDA kernel and copy intervals that
    ``torch.profiler`` records over ``iters`` calls, summed, per call.
    Host launch overhead is not in it (``cuda_ms``, from events around the
    whole loop, includes it wherever the host is slower than the card).
    A window that recorded fewer kernels than launches (a dropped record
    would read as a faster call) is taken again, up to three windows; if
    every one falls short, the last one's time is scaled by launches over
    kernels and counted in ``SCALED``.  Where the profiler records no
    device activity (its CUPTI tracing is not available on every host),
    the call is timed with CUDA events instead, counted in ``EVENT_TIMED``
    and reported as such."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    scaled = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        total_us = sum(e.time_range.end - e.time_range.start for e in events
                       if e.device_type == cuda)
        launches, kernels = launches_and_kernels(torch, events)
        if total_us > 0 and kernels >= launches:
            return total_us / iters / 1e3
        if total_us > 0 and kernels > 0:
            scaled = total_us * launches / kernels / iters / 1e3
    if scaled is not None:
        SCALED.append(iters)
        return scaled
    if not EVENT_TIMED:
        log("timer: torch.profiler recorded no device time; timing with CUDA events "
            "(host launch included) from here on where it sees none")
    EVENT_TIMED.append(iters)
    return cuda_ms(fn, iters, warmup=0)


def timings(torch, kernel, plain, library, iters: int, plain_iters: int | None = None) -> dict:
    """Device ms of the kernel, its plain version (over ``plain_iters``
    calls; default a quarter of ``iters``, at least 10) and the library call
    (None: no library call), and the kernel's ms from CUDA events around a
    loop of calls (host launch overhead included)."""
    return {"ms": device_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, plain_iters or max(iters // 4, 10)),
            "library_ms": None if library is None else device_ms(torch, library, iters),
            "event_ms": cuda_ms(kernel, iters)}


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
    if not bool(live.all()) and 0 not in pages:   # idle rows: the mean of page 0's V
        kv += ps * Hkv * hd * k.element_size()
    io = 2 * q.numel() * q.element_size() + table.numel() * 4 + q_pos.numel() * 4
    flops = 4.0 * entries * Hq * hd
    t_bytes, t_ops = (kv + io) / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa(torch, q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call over [B, H, S, hd] views,
    GQA heads broadcast by the call itself (``enable_gqa``); where this
    PyTorch lacks it, K/V heads are expanded before the timed call."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def dense_case(torch, form, *, B=8, Hq=8, Hkv=1, hd=256, C=1024, seed=1):
    """gemma-2b dense decode shapes.  per_row (the slot engine): rows at
    mixed depths and an idle row (7) that keeps no entry; shared (the wave
    engine): a 333-token prompt 16 tokens into its decode.  Returns tensors
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").bfloat16()
    if form == "per_row":
        lengths = [1024, 37, 512, 700, 333, 129, 1000, 0]
        kv_pos = torch.full((B, C), -1, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    else:
        n = 333 + 16
        kv_pos = torch.full((C,), -1, dtype=torch.int32)
        kv_pos[:n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor(n - 1, dtype=torch.int32)
    return q, k, v, kv_pos.cuda(), q_pos.cuda()


def dense_keep(B, kv_pos, q_pos, window):
    """[B, C] mask of the entries each row keeps (on the host)."""
    kp, qp = kv_pos.cpu(), q_pos.cpu()
    if kp.dim() == 1:
        kp, qp = kp[None].expand(B, -1), qp.reshape(1).expand(B)
    keep = (kp >= 0) & (kp <= qp[:, None])
    if window is not None:
        keep = keep & (kp > qp[:, None] - window)
    return keep


def dense_bound_ms(q, k, kv_pos, q_pos, window) -> tuple[float, str]:
    """Least time for this call's work: the K/V entries its rows keep (each
    read once), all of V for a row that keeps none (its output is the mean
    of V), q, kv_pos, q_pos and the output, over the HBM rate; or its flops
    over the bf16 rate, whichever is larger."""
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    keep = dense_keep(B, kv_pos, q_pos, window)
    entries, empty_rows = int(keep.sum()), int((keep.sum(dim=1) == 0).sum())
    kv = (2 * entries + empty_rows * S) * Hkv * hd * k.element_size()
    io = 2 * q.numel() * q.element_size() + 4 * (kv_pos.numel() + q_pos.numel())
    flops = 4.0 * entries * Hq * hd + empty_rows * S * Hkv * hd
    t_bytes, t_ops = (kv + io) / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def paged_as_dense(torch, k, v, table):
    """The entries a paged call reads, laid out as a dense per-row cache
    (unmapped pages read as page 0 and hold no position): the same work for
    B2, as a yardstick for B1's gather."""
    B, n_pt = table.shape
    _, ps, Hkv, hd = k.shape
    pages = table.clamp(min=0).long()
    kd = k[pages].reshape(B, n_pt * ps, Hkv, hd).contiguous()
    vd = v[pages].reshape(B, n_pt * ps, Hkv, hd).contiguous()
    pos = torch.arange(n_pt * ps, dtype=torch.int32, device=k.device)[None].expand(B, -1)
    kv_pos = torch.where((table >= 0).repeat_interleave(ps, dim=1), pos, -1).contiguous()
    return kd, vd, kv_pos


def decode_split_of(torch, q, n_entries: int, Hkv: int) -> list:
    """The (n_c, chunk) the decode core takes for this launch."""
    from repro_torch.kernels.decode_attention import decode_split

    B, Hq, hd = q.shape
    clusters = B * Hkv * -(-(Hq // Hkv) // 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(decode_split(n_entries, q.element_size(), hd, clusters, sms))


def kernels_per_call(torch, fn, calls: int = 4) -> float:
    """Kernels per call of ``fn`` that ``torch.profiler`` records: the
    larger of its launches on the host and its kernels on the device
    (``launches_and_kernels``).  None where it records neither on this
    host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = max(launches_and_kernels(torch, prof.events()))
    return n / calls if n else None


def check_one_kernel(torch, name: str, fn) -> None:
    """B1, B2, B4 and B7 are one launch a call (B1 / B2's split-K merge is in
    the kernel; B7's ring needs no second pass)."""
    n = kernels_per_call(torch, fn)
    if n is not None and n != 1:
        fail(f"{name}: torch.profiler records {n} kernels per call, not 1")


def flash_case(torch, S, *, Hq=8, Hkv=1, hd=256, seed=2):
    """gemma-2b prefill shapes: one prompt of S tokens, model layout."""
    gen = torch.Generator(device="cuda").manual_seed(seed + S)
    q = torch.randn((1, S, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    return q, k, v


def flash_keep(torch, S, window):
    i = torch.arange(S, device="cuda")
    keep = i[None, :] <= i[:, None]
    if window is not None:
        keep = keep & (i[None, :] > i[:, None] - window)
    return keep


def flash_bound_ms(torch, q, k, window) -> tuple[float, str]:
    """Least time for a causal call: q, k, v read once and the output
    written once over the HBM rate, or the kept (query, key) pairs' flops
    over the bf16 rate, whichever is larger."""
    B, S, Hq, hd = q.shape
    pairs = int(flash_keep(torch, S, window).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4.0 * B * pairs * Hq * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(torch, name, out, ref, tol=KERNEL_TOL) -> float:
    """Every element of ``out`` finite and within ``tol`` of ``ref``."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name} wrote non-finite values")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        fail(f"{name} max abs err {err} > {tol}")
    return err


def lstm_cell_case(torch, N, H, gates, state, *, seed=4):
    """B4 inputs: the two GEMM outputs [N, 4H], the bias and the state."""
    gen = torch.Generator(device="cuda").manual_seed(seed + N + H)
    gx = torch.randn((N, 4 * H), generator=gen, device="cuda").to(gates)
    gh = torch.randn((N, 4 * H), generator=gen, device="cuda").to(gates)
    b = torch.randn((4 * H,), generator=gen, device="cuda").to(gates)
    c = torch.randn((N, H), generator=gen, device="cuda").to(state)
    return gx, gh, b, c


def lstm_cell_bound_ms(gx, gh, b, c) -> tuple[float, str]:
    """Least time for one cell update: gx, gh, b and c read once, h and c'
    written once, over the HBM rate; or ~8 ops per gate element over the
    f32 rate (the math is f32 on the CUDA cores), whichever is larger."""
    N, H = c.shape
    nbytes = ((gx.numel() + gh.numel()) * gx.element_size() + b.numel() * b.element_size()
              + 2 * c.numel() * c.element_size() + N * H * gx.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8.0 * gx.numel() / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def thnn_lstm_cell(torch, gx, gh, b, c):
    """PyTorch's own fused LSTM pointwise kernel on the same inputs: gate
    order i,f,g,o as here but no +1 on the forget gate, so the bias it gets
    carries the +1; one dtype for everything, so a mixed case hands it the
    state in the gates' dtype.  A yardstick only: the port never calls it."""
    H = c.shape[1]
    bs = b.to(gx.dtype).clone()
    bs[H:2 * H] += 1.0
    zero = torch.zeros_like(bs)
    cs = c.to(gx.dtype)
    return lambda: torch.ops.aten._thnn_fused_lstm_cell(gx, gh, cs, bs, zero)


def moe_gmm_case(torch, E, C, D, F, dtype, *, seed=5):
    """B5 inputs: an expert batch [E, C, D] and expert weights [E, D, F]
    at the model's scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed + C + D)
    x = torch.randn((E, C, D), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device="cuda") * D ** -0.5).to(dtype)
    return x, w


def moe_gmm_bound_ms(x, w) -> tuple[float, str]:
    """Least time for one grouped product: x and w read once and the output
    written once over the HBM rate, or 2·E·C·D·F flops over the rate of
    their type (bf16 tensor cores; f32 outside them), whichever is larger."""
    E, C, D = x.shape
    F = w.shape[2]
    nbytes = (x.numel() + w.numel() + E * C * F) * x.element_size()
    flops = 2.0 * E * C * D * F
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if x.element_size() == 2 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssm_scan_case(torch, B, S, D, St, c_dtype, h0, *, seed=6):
    """B6 inputs with the model's distributions: a = exp(-dt·A), dt in
    [0.001, 0.1] and A = 1..St (the S4D-real init), b = dt·B·x, c and x
    standard normal; c in the dtype the model's x_proj gives it."""
    gen = torch.Generator(device="cuda").manual_seed(seed + S + D)
    dt = torch.rand((B, S, D, 1), generator=gen, device="cuda") * 0.099 + 0.001
    a = torch.exp(-dt * torch.arange(1, St + 1, dtype=torch.float32, device="cuda"))
    b = dt * torch.randn((B, S, 1, St), generator=gen, device="cuda") \
        * torch.randn((B, S, D, 1), generator=gen, device="cuda")
    c = torch.randn((B, S, St), generator=gen, device="cuda").to(c_dtype)
    h = torch.randn((B, D, St), generator=gen, device="cuda") if h0 else None
    return a, b, c, h


def rglru_scan_case(torch, B, S, R, h0, *, seed=7):
    """B7 inputs with the model's distributions: a = exp(-8·softplus(Λ)·r)
    over recurrentgemma's Λ init and r in (0, 1), b = sqrt(1 - a²)·N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + S + R)
    lam = torch.log(torch.expm1(torch.linspace(0.3, 1.3, R, device="cuda")))
    r = torch.rand((B, S, R), generator=gen, device="cuda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    b = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * torch.randn((B, S, R), generator=gen,
                                                                      device="cuda")
    h = torch.randn((B, R), generator=gen, device="cuda") if h0 else None
    return a, b, h


def scan_bound_ms(inputs, outputs, flops: float) -> tuple[float, str]:
    """Least time for one scan: every input read once and every output
    written once over the HBM rate, or its flops over the f32 rate (the
    recurrence is f32 on the CUDA cores), whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs) if t is not None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_kernel_rows(torch) -> dict:
    """B6 and B7 against their plain versions on the same inputs, every
    element of both outputs within the f32 tolerance; the same bits on a
    second call; device times of kernel and plain version (no single
    PyTorch call computes either scan: library_ms is None)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda, rglru_scan_plain, scan_tiles
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain

    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows: dict[str, dict] = {"ssm_scan": {}, "rglru_scan": {}}
    carry = (torch.full((1, 128, 8, 4), 0.999, device="cuda"),
             torch.zeros((1, 128, 8, 4), device="cuda").index_fill_(
                 1, torch.tensor([0], device="cuda"), 1.0),
             torch.ones((1, 128, 4), device="cuda"), None)
    for case, args in (
            ("prefill,B=1,S=333,D=8192,St=16",
             ssm_scan_case(torch, 1, 333, 8192, 16, bf16, False)),
            ("decode,B=8,S=1,D=8192,St=16", ssm_scan_case(torch, 8, 1, 8192, 16, bf16, True)),
            ("ragged,B=2,S=37,D=200,St=16", ssm_scan_case(torch, 2, 37, 200, 16, f32, True)),
            ("state_carry,B=1,S=128,D=8,St=4", carry)):
        y, h = ssm_scan_cuda(*args)
        ry, rh = ssm_scan_plain(*args)
        err = max(check_kernel(torch, f"ssm_scan kernel ({case}) y", y, ry, tol=F32_KERNEL_TOL),
                  check_kernel(torch, f"ssm_scan kernel ({case}) h", h, rh, tol=F32_KERNEL_TOL))
        y2, h2 = ssm_scan_cuda(*args)
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            fail(f"ssm_scan kernel ({case}) differs between two calls")
        if case.startswith("state_carry"):
            want = 4 * 0.999 ** 127         # tests/test_kernels.py:234
            if abs(y[0, -1, 0].item() - want) > 1e-4 * want:
                fail(f"ssm_scan kernel lost the state across steps: {y[0, -1, 0].item()}")
        t = timings(torch, lambda a=args: ssm_scan_cuda(*a), lambda a=args: ssm_scan_plain(*a),
                    None, 20)
        bound_ms, bound_by = scan_bound_ms(args, (y, h), 4.0 * args[0].numel())
        rows["ssm_scan"][case] = {"max_abs_err": err, "h_bit_equal": torch.equal(h, rh), **t,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
    # recurrentgemma-2b: a slot prefill of 333 tokens, the wave engine's 4 x
    # 333, a prompt of 2048 (its attention window), a decode step of 8 slots
    for case, args in (("prefill,B=1,S=333,R=2560", rglru_scan_case(torch, 1, 333, 2560, False)),
                       ("prefill,B=4,S=333,R=2560", rglru_scan_case(torch, 4, 333, 2560, False)),
                       ("prefill,B=1,S=2048,R=2560",
                        rglru_scan_case(torch, 1, 2048, 2560, False)),
                       ("decode,B=8,S=1,R=2560", rglru_scan_case(torch, 8, 1, 2560, True)),
                       ("ragged,B=2,S=37,R=200", rglru_scan_case(torch, 2, 37, 200, True))):
        hs, h = rglru_scan_cuda(*args)
        rhs, rh = rglru_scan_plain(*args)
        err = max(check_kernel(torch, f"rglru_scan kernel ({case}) hs", hs, rhs,
                               tol=F32_KERNEL_TOL),
                  check_kernel(torch, f"rglru_scan kernel ({case}) h", h, rh, tol=F32_KERNEL_TOL))
        # the chain rounds as the plain version does: the same bits, not close
        if not (torch.equal(hs, rhs) and torch.equal(h, rh)):
            fail(f"rglru_scan kernel ({case}) is not bit-equal to its plain version")
        hs2, h2 = rglru_scan_cuda(*args)
        if not (torch.equal(hs2, hs) and torch.equal(h2, h)):
            fail(f"rglru_scan kernel ({case}) differs between two calls")
        check_one_kernel(torch, f"rglru_scan kernel ({case})",
                         lambda a=args: rglru_scan_cuda(*a))
        t = timings(torch, lambda a=args: rglru_scan_cuda(*a),
                    lambda a=args: rglru_scan_plain(*a), None, 20)
        bound_ms, bound_by = scan_bound_ms(args, (hs, h), 2.0 * args[0].numel())
        rows["rglru_scan"][case] = {"max_abs_err": err, "bit_equal": True, **t,
                                    "bound_ms": bound_ms, "bound_by": bound_by,
                                    "tiles": list(scan_tiles(*args[0].shape, sms))}
    return rows


def kernel_phase(torch) -> dict:
    """Each kernel against its plain version on the same inputs; device
    times of the kernel, the plain version and one library call.  Returns
    ``{kernel: {case: row}}``; these launches are not the main path's."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain,
                                                      paged_decode_attention_cuda,
                                                      paged_decode_attention_plain)
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.lstm_cell import cell_tiles, lstm_cell_cuda, lstm_cell_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_path, moe_gmm_plain

    rows: dict[str, dict] = {"paged_decode_attention": {}, "decode_attention": {},
                             "flash_attention": {}, "lstm_cell": {}, "moe_gmm": {}}
    # granite-moe-1b-a400m's attention: 16 query heads over 8 KV heads of 64;
    # olmoe-1b-7b's: 16 heads of 128 (B3's hd-128 tensor-core instantiation)
    granite = {"Hq": 16, "Hkv": 8, "hd": 64}
    olmoe = {"Hq": 16, "Hkv": 16, "hd": 128}
    # h2o-danube3-4b's: 32 query heads over 8 KV heads of 120 (d_model 3840)
    h2o = {"Hq": 32, "Hkv": 8, "hd": 120}

    for shape, windows in (("", (None, 256)), ("granite,", (None,))):
        q, k, v, table, q_pos, live = paged_case(torch, **(granite if shape else {}))
        for window in windows:
            out = paged_decode_attention_cuda(q, k, v, table, q_pos, window)
            ref = paged_decode_attention_plain(q, k, v, table, q_pos, window)
            # every row, the idle one included: a MoE FFN routes it too
            err = check_kernel(torch, f"paged kernel ({shape}window={window})", out, ref)
            call = lambda w=window: paged_decode_attention_cuda(q, k, v, table, q_pos, w)
            if not torch.equal(out, call()):
                fail(f"paged kernel ({shape}window={window}) differs between two calls")
            check_one_kernel(torch, f"paged kernel ({shape}window={window})", call)
            t = timings(torch, call,
                        lambda w=window: paged_decode_attention_plain(q, k, v, table, q_pos, w),
                        None, 200)
            # the same entries in a dense cache through B2: the gather's cost
            kd, vd, kv_pos = paged_as_dense(torch, k, v, table)
            check_kernel(torch, f"dense yardstick of the paged case ({shape}window={window})",
                         decode_attention_cuda(q, kd, vd, kv_pos, q_pos, window), ref)
            dense_ms = device_ms(
                torch, lambda w=window: decode_attention_cuda(q, kd, vd, kv_pos, q_pos, w), 200)
            bound_ms, bound_by = paged_bound_ms(q, k, table, q_pos, live, window)
            rows["paged_decode_attention"][f"{shape}window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "dense_ms": dense_ms,
                "split": decode_split_of(torch, q, table.shape[1] * k.shape[1], k.shape[2])}

    for form, windows, shape, tag in (("per_row", (None, 256), {}, ""),
                                      ("shared", (None, 256), {}, ""),
                                      ("per_row", (None,), granite, "granite,"),
                                      ("per_row", (None,), h2o, "h2o,")):
        q, k, v, kv_pos, q_pos = dense_case(torch, form, **shape)
        form = f"{tag}{form}"
        for window in windows:
            out = decode_attention_cuda(q, k, v, kv_pos, q_pos, window)
            ref = decode_attention_plain(q, k, v, kv_pos, q_pos, window)
            # every row, the idle one included: it writes the mean of V
            err = check_kernel(torch, f"dense decode kernel ({form}, window={window})",
                               out, ref)
            if not torch.equal(out, decode_attention_cuda(q, k, v, kv_pos, q_pos, window)):
                fail(f"dense decode kernel ({form}) differs between two calls")
            check_one_kernel(torch, f"dense decode kernel ({form}, window={window})",
                             lambda w=window: decode_attention_cuda(q, k, v, kv_pos, q_pos, w))
            mask = dense_keep(q.shape[0], kv_pos, q_pos, window).cuda()[:, None, None, :]
            t = timings(torch,
                        lambda w=window: decode_attention_cuda(q, k, v, kv_pos, q_pos, w),
                        lambda w=window: decode_attention_plain(q, k, v, kv_pos, q_pos, w),
                        sdpa(torch, q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                             attn_mask=mask), 200)
            bound_ms, bound_by = dense_bound_ms(q, k, kv_pos, q_pos, window)
            rows["decode_attention"][f"{form},window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "split": decode_split_of(torch, q, k.shape[1], k.shape[2])}

    for S, windows, shape, tag in ((512, (None, 256), {}, ""), (333, (None, 256), {}, ""),
                                   (333, (None,), granite, "granite,"),
                                   (512, (None,), olmoe, "olmoe,"), (2048, (None,), {}, "")):
        q, k, v = flash_case(torch, S, **shape)
        for window in windows:
            out = flash_attention_cuda(q, k, v, True, window, 0)
            ref = flash_attention_plain(q, k, v, True, window, 0, 1024, 512)
            err = check_kernel(torch, f"flash kernel ({tag}S={S}, window={window})", out, ref)
            if not torch.equal(flash_attention_cuda(q, k, v, True, window, 0), out):
                fail(f"flash kernel ({tag}S={S}, window={window}) differs between two calls")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = (sdpa(torch, qt, kt, vt, is_causal=True) if window is None else
                   sdpa(torch, qt, kt, vt, attn_mask=flash_keep(torch, S, window)))
            t = timings(torch, lambda w=window: flash_attention_cuda(q, k, v, True, w, 0),
                        lambda w=window: flash_attention_plain(q, k, v, True, w, 0, 1024, 512),
                        lib, 50)
            bound_ms, bound_by = flash_bound_ms(torch, q, k, window)
            rows["flash_attention"][f"{tag}S={S},window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by}

    f32, bf16 = torch.float32, torch.bfloat16
    for N, H, gates, state in ((64, 1024, f32, f32), (256, 1024, f32, f32),
                               (64, 1024, bf16, f32), (37, 200, f32, f32)):
        gx, gh, b, c = lstm_cell_case(torch, N, H, gates, state)
        case = f"N={N},H={H},{str(gates)[6:]}/{str(state)[6:]}"
        tol = KERNEL_TOL if bf16 in (gates, state) else F32_KERNEL_TOL
        h, c_new = lstm_cell_cuda(gx, gh, b, c)
        h_ref, c_ref = lstm_cell_plain(gx, gh, b, c)
        if h.dtype != gates or c_new.dtype != state:
            fail(f"lstm_cell kernel ({case}) stored h {h.dtype}, c' {c_new.dtype}")
        err = max(check_kernel(torch, f"lstm_cell kernel ({case}) h", h, h_ref, tol=tol),
                  check_kernel(torch, f"lstm_cell kernel ({case}) c'", c_new, c_ref, tol=tol))
        again = lstm_cell_cuda(gx, gh, b, c)
        if not (torch.equal(again[0], h) and torch.equal(again[1], c_new)):
            fail(f"lstm_cell kernel ({case}) differs between two calls")
        check_one_kernel(torch, f"lstm_cell kernel ({case})",
                         lambda a=(gx, gh, b, c): lstm_cell_cuda(*a))
        lib = thnn_lstm_cell(torch, gx, gh, b, c)
        lib_h, lib_c = lib()[:2]
        lib_err = max(check_kernel(torch, f"aten._thnn_fused_lstm_cell ({case}) h", lib_h,
                                   h_ref, tol=tol),
                      check_kernel(torch, f"aten._thnn_fused_lstm_cell ({case}) c'", lib_c,
                                   c_ref, tol=tol))
        args = (gx, gh, b, c)
        t = timings(torch, lambda a=args: lstm_cell_cuda(*a),
                    lambda a=args: lstm_cell_plain(*a), lib, 200)
        bound_ms, bound_by = lstm_cell_bound_ms(gx, gh, b, c)
        rows["lstm_cell"][case] = {
            "max_abs_err": err, "library_err": lib_err, **t, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "tiles": list(cell_tiles(N, H, gx.element_size(),
                                     torch.cuda.get_device_properties(0).multi_processor_count))}

    # B5 at the MoE serve phase's shapes (granite: E = 32, D x F = 1024 x 512
    # for gate / up, 512 x 1024 for down): a decode step's 8 slots in both
    # forms, a paged chunk of 128 (C = 40), a slot prefill of 333 (C = 104),
    # waves of 4 x 200 (C = 256) and 4 x 333 (C = 416); f32; a ragged shape
    # no tile divides.
    # Four copies of the weights (134 MB, over the 50 MB L2) are cycled so
    # each call reads its weights from device memory, as each layer's
    # differ on the serve path.
    import itertools

    for E, C, D, F, dt in ((32, 8, 1024, 512, bf16), (32, 8, 512, 1024, bf16),
                           (32, 40, 1024, 512, bf16), (32, 104, 1024, 512, bf16),
                           (32, 256, 1024, 512, bf16), (32, 416, 1024, 512, bf16),
                           (32, 104, 1024, 512, f32), (3, 37, 200, 72, bf16)):
        case = f"E={E},C={C},D={D},F={F},{str(dt)[6:]}"
        x, w = moe_gmm_case(torch, E, C, D, F, dt)
        tol = F32_KERNEL_TOL if dt == f32 else KERNEL_TOL
        out = moe_gmm_cuda(x, w)
        if out.dtype != dt or tuple(out.shape) != (E, C, F):
            fail(f"moe_gmm kernel ({case}) gave {out.dtype} {tuple(out.shape)}")
        err = check_kernel(torch, f"moe_gmm kernel ({case})", out, moe_gmm_plain(x, w), tol=tol)
        if not torch.equal(moe_gmm_cuda(x, w), out):
            fail(f"moe_gmm kernel ({case}) differs between two calls")
        lib_err = check_kernel(torch, f"torch.bmm ({case})", torch.bmm(x, w),
                               moe_gmm_plain(x, w), tol=tol)
        ws = itertools.cycle([w] + [w.clone() for _ in range(3)])
        t = timings(torch, lambda: moe_gmm_cuda(x, next(ws)),
                    lambda: moe_gmm_plain(x, next(ws)), lambda: torch.bmm(x, next(ws)), 200)
        bound_ms, bound_by = moe_gmm_bound_ms(x, w)
        rows["moe_gmm"][case] = {"max_abs_err": err, "library_err": lib_err, **t,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "path": moe_gmm_path(x, w)}

    rows.update(scan_kernel_rows(torch))
    rows.update(train_kernel_rows(torch))
    t0 = time.perf_counter()
    rows.update(family_bwd_kernel_rows(torch))
    log(f"kernels: the B5 / B6 / B7 backward rows in {time.perf_counter() - t0:.1f}s")

    for name, cases in rows.items():
        for case, r in cases.items():
            extra = "".join(f" {key}={r[key]}" for key in ("form", "split", "splits",
                                                            "dense_ms", "tiles", "fwd_bwd_ms",
                                                            "lse_err", "dx_ms", "dw_ms",
                                                            "library_dx_ms", "library_dw_ms",
                                                            "serving_ms", "bit_equal")
                            if key in r)
            if "ms" not in r:                 # a correctness case, not timed
                log(f"kernel {name} {case}: max_abs_err={r['max_abs_err']:.3e}{extra}")
                continue
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"kernel {name} {case}: max_abs_err={r['max_abs_err']:.3e} ms={r['ms']:.4f} "
                f"(events {r['event_ms']:.4f}) plain_ms={r['plain_ms']:.4f} "
                f"library_ms={lib} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}){extra}")
    return rows


def flash_bwd_bound_ms(torch, q, k, window) -> tuple[float, str]:
    """Least time for one backward call: q, k, v, out, dout and lse read
    once, dq, dk and dv written once, over the HBM rate; or the
    kept pairs' five products (P recomputed, dP, dV, dK, dQ: 10 flops a
    pair a head-dim element) over the tensor-core rate of the dtype (the
    f32 rate for f32), whichever is larger."""
    B, S, Hq, hd = q.shape
    pairs = int(flash_keep(torch, S, window).sum())
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * B * Hq * S
    flops = 10.0 * B * pairs * Hq * hd
    rate = F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_fwd_bwd(torch, q, k, v, do, window):
    """PyTorch's fused attention forward and backward on the same inputs
    (its GQA form, a boolean mask for the window): the yardstick of B3's
    forward + backward.  The port never calls it."""
    F = torch.nn.functional
    S = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    kw = ({"is_causal": True} if window is None
          else {"attn_mask": flash_keep(torch, S, window)})

    def call():
        o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
        return torch.autograd.grad(o, (qt, kt, vt), dot)
    return call


def lstm_cell_bwd_bound_ms(gx, c) -> tuple[float, str]:
    """Least time for one backward cell update: gx, gh, b, c, dh and dc
    read once, dgates and dc_prev written once, over the HBM rate; or ~30
    ops per element of h over the f32 rate, whichever is larger."""
    N, H = c.shape
    g, st = gx.element_size(), c.element_size()
    nbytes = 3 * N * 4 * H * g + 4 * H * g + N * H * (g + 3 * st)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 30.0 * N * H / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def thnn_lstm_cell_bwd(torch, gx, gh, b, c, dh, dc):
    """PyTorch's own fused LSTM backward pointwise kernel on the same
    inputs (``aten._thnn_fused_lstm_cell_backward_impl`` after its
    forward, with the +1 of the forget gate in the bias as in
    :func:`thnn_lstm_cell`); returns the call and its gate gradients.
    A yardstick only: the port never calls it."""
    H = c.shape[1]
    bs = b.to(gx.dtype).clone()
    bs[H:2 * H] += 1.0
    cs = c.to(gx.dtype)
    _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(gx, gh, cs, bs, torch.zeros_like(bs))
    dcs = dc.to(gx.dtype)

    def call():
        return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dh, dcs, cs, cy, ws, True)
    return call, call()[0]


def train_kernel_rows(torch) -> dict:
    """The backward kernels of B3 and B4 against their plain versions on
    the same inputs, every element of every gradient; the same bits on a
    second call; device times of the kernel, the plain version and a
    library call.  B3's backward at gemma-2b's training shape (B=4, S=512,
    8 / 1 heads of 256, bf16), with a 256-token window, at granite-moe's
    (16 / 8 heads of 64) and recurrentgemma's (10 / 1 heads of 256, its
    2048-token window: fully causal at S=512), and in f32 at the small
    train phase's shape (the smoke config: 4 / 1 heads of 16, B=2, S=32);
    its training forward's log-sum-exp against the plain version's
    and its output bit-equal to the serving call's; each row names the
    form the call takes (tensor cores for bf16, SIMT for f32) and its split
    of a key tile's query heads (``flash_bwd_splits``).  B4's backward at
    the LSTM's N=64, H=1024, f32 and with bf16 gates."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_path,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda,
                                                     flash_attention_train_cuda, flash_bwd_splits)
    from repro_torch.kernels.flash_attention.ops import _plain_forward
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda, lstm_cell_bwd_plain

    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict[str, dict] = {"flash_attention_bwd": {}, "lstm_cell_bwd": {}}
    for case, (B, S, Hq, Hkv, hd, window, dt) in (
            ("B=4,S=512,window=None,bfloat16", (4, 512, 8, 1, 256, None, bf16)),
            ("B=4,S=512,window=256,bfloat16", (4, 512, 8, 1, 256, 256, bf16)),
            ("smoke,B=2,S=32,float32", (2, 32, 4, 1, 16, None, f32)),
            # granite-moe-1b-a400m's and recurrentgemma-2b's training shapes:
            # 16 / 8 heads of 64; 10 / 1 heads of 256 under its 2048 window
            ("granite,B=4,S=512,Hq=16,Hkv=8,hd=64,bfloat16", (4, 512, 16, 8, 64, None, bf16)),
            ("recurrentgemma,B=4,S=512,Hq=10,Hkv=1,hd=256,window=2048,bfloat16",
             (4, 512, 10, 1, 256, 2048, bf16))):
        gen = torch.Generator(device="cuda").manual_seed(8 + S + hd)
        q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        do = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(dt)
        tol = F32_KERNEL_TOL if dt == f32 else KERNEL_TOL
        out, lse = flash_attention_train_cuda(q, k, v, True, window, 0)
        if not torch.equal(out, flash_attention_cuda(q, k, v, True, window, 0)):
            fail(f"flash training forward ({case}) differs from the serving call")
        lse_err = check_kernel(torch, f"flash training forward lse ({case})", lse,
                               _plain_forward(q, k, v, True, window, 0, 1024, 512)[1], tol=tol)
        args = (do, q, k, v, out, lse, True, window, 0)
        got = flash_attention_bwd_cuda(*args)
        ref = flash_attention_bwd_plain(*args)
        err = max(check_kernel(torch, f"flash backward kernel ({case}) {name}", a, b, tol=tol)
                  for name, a, b in zip(("dq", "dk", "dv"), got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd_cuda(*args))):
            fail(f"flash backward kernel ({case}) differs between two calls")
        lib = sdpa_fwd_bwd(torch, q, k, v, do, window)
        lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                      for a, b in zip(lib(), ref))
        t = timings(torch, lambda a=args: flash_attention_bwd_cuda(*a),
                    lambda a=args: flash_attention_bwd_plain(*a), lib, 20)

        def fwd_bwd(q=q, k=k, v=v, do=do, window=window):
            o, l = flash_attention_train_cuda(q, k, v, True, window, 0)
            return flash_attention_bwd_cuda(do, q, k, v, o, l, True, window, 0)
        bound_ms, bound_by = flash_bwd_bound_ms(torch, q, k, window)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows["flash_attention_bwd"][case] = {
            "max_abs_err": err, "lse_err": lse_err, "library_err": lib_err, **t,
            "fwd_bwd_ms": device_ms(torch, fwd_bwd, 20), "bound_ms": bound_ms,
            "bound_by": bound_by, "form": flash_attention_bwd_path(dt),
            "splits": flash_bwd_splits(B, S, Hq, Hkv, sms)}

    for N, H, gates, state in ((64, 1024, f32, f32), (64, 1024, bf16, f32)):
        gx, gh, b, c = lstm_cell_case(torch, N, H, gates, state)
        gen = torch.Generator(device="cuda").manual_seed(9 + N + H)
        dh = torch.randn((N, H), generator=gen, device="cuda").to(gates)
        dc = torch.randn((N, H), generator=gen, device="cuda").to(state)
        case = f"N={N},H={H},{str(gates)[6:]}/{str(state)[6:]}"
        tol = KERNEL_TOL if bf16 in (gates, state) else F32_KERNEL_TOL
        args = (gx, gh, b, c, dh, dc)
        dg, dcp = lstm_cell_bwd_cuda(*args)
        rg, rc = lstm_cell_bwd_plain(*args)
        if dg.dtype != gates or dcp.dtype != state:
            fail(f"lstm_cell backward kernel ({case}) stored {dg.dtype}, {dcp.dtype}")
        err = max(check_kernel(torch, f"lstm_cell backward kernel ({case}) dgates", dg, rg,
                               tol=tol),
                  check_kernel(torch, f"lstm_cell backward kernel ({case}) dc", dcp, rc,
                               tol=tol))
        again = lstm_cell_bwd_cuda(*args)
        if not (torch.equal(again[0], dg) and torch.equal(again[1], dcp)):
            fail(f"lstm_cell backward kernel ({case}) differs between two calls")
        check_one_kernel(torch, f"lstm_cell backward kernel ({case})",
                         lambda a=args: lstm_cell_bwd_cuda(*a))
        lib, lib_dg = thnn_lstm_cell_bwd(torch, *args)
        # a yardstick, not gated: with bf16 gates it gets the state in bf16
        lib_err = (lib_dg.float() - rg.float()).abs().max().item()
        t = timings(torch, lambda a=args: lstm_cell_bwd_cuda(*a),
                    lambda a=args: lstm_cell_bwd_plain(*a), lib, 200)
        bound_ms, bound_by = lstm_cell_bwd_bound_ms(gx, c)
        rows["lstm_cell_bwd"][case] = {"max_abs_err": err, "library_err": lib_err, **t,
                                       "bound_ms": bound_ms, "bound_by": bound_by}
    return rows


def moe_gmm_bwd_half(torch, x, w, dy, half: str):
    """A call that launches one half of B5-bwd alone (``"dx"`` or
    ``"dw"``), in the form the wrapper takes, for that half's time: the C
    entry skips the product whose output pointer is null.  Not a main-path
    launch, so it counts nothing."""
    from repro_torch.kernels.moe_gmm import ops

    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty_like(x if half == "dx" else w)
    outs = (out.data_ptr(), None) if half == "dx" else (None, out.data_ptr())
    mma = int(ops.moe_gmm_bwd_path(x, w, dy) == "mma")
    dw_first = int(ops.moe_gmm_bwd_dw_first(C, D, F))

    def call():
        err = ops._lib().moe_gmm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), *outs,
                                     ops._DTYPE_CODES[x.dtype], E, C, D, F, mma, dw_first,
                                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"moe_gmm backward kernel's {half} half failed to launch: CUDA error {err}")
        return out
    return call


def moe_gmm_bwd_bound_ms(x, w) -> tuple[float, str]:
    """Least time for one backward call: x, w and dy read once, dx and dw
    written once, over the HBM rate; or the two products' 4·E·C·D·F flops
    over the rate of their type, whichever is larger."""
    E, C, D = x.shape
    F = w.shape[2]
    nbytes = 2 * (x.numel() + w.numel()) * x.element_size() + E * C * F * x.element_size()
    flops = 4.0 * E * C * D * F
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if x.element_size() == 2 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


NO_SCAN_LIBRARY = ("no single PyTorch call computes a linear recurrence or its reverse "
                   "(autograd of a cumprod formula is many calls and other sums)")


def family_bwd_kernel_rows(torch) -> dict:
    """The backward kernels of B5, B6 and B7 against their plain backwards
    on the same inputs, every element of every gradient; the same bits on a
    second call (B6's da, db, dh0 and all of B7's bit-equal to the plain
    version: the same chain, rounded alike); device times of the kernel and
    the plain version, and for B5 one ``torch.bmm`` for dX and one for dW,
    each beside the kernel's own half (no single PyTorch call computes
    either scan's backward: library_ms is None); B5's tensor-core form one
    device kernel a call.  B6's training forward too: y and h_last
    bit-equal to the serving kernel's and its checkpoints to
    ``ssm_scan_train_plain``'s at S = 1, 31, 32, 33, 333 and 512, and its
    time beside the serving kernel's; B6-bwd reads those checkpoints.
    Shapes: each training
    path's — granite-moe-1b-a400m at B=4, S=512 (E=32, C=640, D x F = 1024
    x 512 for gate / up, 512 x 1024 for down, bf16 on the tensor cores),
    falcon-mamba-7b's scan at B=4, S=512 (D=8192, St=16, c in bf16),
    recurrentgemma-2b's at B=4, S=512 (R=2560) — the small train phase's
    f32 smoke shapes (SIMT), and ragged ones (C not a multiple of 128, D
    and F multiples of 8 but not of 64, sums long enough to wrap the mma
    form's 4-stage ring within a tile).  Each checked gradient has a
    standard deviation of 0.25, so a one-ulp bf16 flip of its largest
    element stays under 3e-2 while a product that drops a 32-wide slice
    of its sum does not: B5-bwd takes two cotangents, dy ~ 0.25 N(0, 1)
    sqrt(D / F) for dX (w is N(0, 1) / sqrt(D)) and 0.25 N(0, 1) /
    sqrt(C) for dW (x is N(0, 1)), and each call is held on the gradient
    its cotangent scales; the scans' dy ~ N(0, 1) / sqrt(D)."""
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda, moe_gmm_bwd_path, moe_gmm_bwd_plain
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_cuda, rglru_scan_bwd_plain,
                                                rglru_scan_cuda)
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda, ssm_scan_bwd_plain, ssm_scan_cuda,
                                              ssm_scan_train_cuda, ssm_scan_train_plain)

    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict[str, dict] = {"moe_gmm_bwd": {}, "ssm_scan_train": {}, "ssm_scan_bwd": {},
                             "rglru_scan_bwd": {}}
    for E, C, D, F, dt, tag in ((32, 640, 1024, 512, bf16, "train,"),
                                (32, 640, 512, 1024, bf16, "train,"),
                                (8, 24, 64, 32, f32, "smoke,"), (3, 37, 200, 72, bf16, "ragged,"),
                                (3, 201, 136, 200, bf16, "ragged,"),
                                (3, 333, 136, 328, bf16, "ragged,"),
                                (3, 37, 100, 72, bf16, "ragged,")):
        case = f"{tag}E={E},C={C},D={D},F={F},{str(dt)[6:]}"
        x, w = moe_gmm_case(torch, E, C, D, F, dt)
        gen = torch.Generator(device="cuda").manual_seed(11 + C + D)
        dy_x = (torch.randn((E, C, F), generator=gen, device="cuda")
                * 0.25 * (D / F) ** 0.5).to(dt)
        dy_w = (torch.randn((E, C, F), generator=gen, device="cuda") * 0.25 * C ** -0.5).to(dt)
        tol = F32_KERNEL_TOL if dt == f32 else KERNEL_TOL
        dx, _ = moe_gmm_bwd_cuda(x, w, dy_x)
        _, dw = moe_gmm_bwd_cuda(x, w, dy_w)
        rx, _ = moe_gmm_bwd_plain(x, w, dy_x)
        _, rw = moe_gmm_bwd_plain(x, w, dy_w)
        if dx.dtype != dt or dw.dtype != dt:
            fail(f"moe_gmm backward kernel ({case}) stored {dx.dtype}, {dw.dtype}")
        err = max(check_kernel(torch, f"moe_gmm backward kernel ({case}) dx", dx, rx, tol=tol),
                  check_kernel(torch, f"moe_gmm backward kernel ({case}) dw", dw, rw, tol=tol))
        for dy in (dy_x, dy_w):
            first, again = moe_gmm_bwd_cuda(x, w, dy), moe_gmm_bwd_cuda(x, w, dy)
            if not (torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])):
                fail(f"moe_gmm backward kernel ({case}) differs between two calls")
        if moe_gmm_bwd_path(x, w, dy_w) == "mma":   # dX and dW in one launch
            check_one_kernel(torch, f"moe_gmm backward kernel ({case})",
                             lambda: moe_gmm_bwd_cuda(x, w, dy_w))
        wt = w.transpose(1, 2)
        lib_dx, lib_dw = (lambda: torch.bmm(dy_x, wt)), (lambda: torch.bmm(x.transpose(1, 2), dy_w))
        lib_err = max(check_kernel(torch, f"torch.bmm dX ({case})", lib_dx(), rx, tol=tol),
                      check_kernel(torch, f"torch.bmm dW ({case})", lib_dw(), rw, tol=tol))
        args = (x, w, dy_w)
        t = timings(torch, lambda a=args: moe_gmm_bwd_cuda(*a),
                    lambda a=args: moe_gmm_bwd_plain(*a), lambda: (lib_dx(), lib_dw()), 50)
        bound_ms, bound_by = moe_gmm_bwd_bound_ms(x, w)
        rows["moe_gmm_bwd"][case] = {
            "max_abs_err": err, "library_err": lib_err, **t, "bound_ms": bound_ms,
            "bound_by": bound_by, "form": moe_gmm_bwd_path(*args),
            "dx_ms": device_ms(torch, moe_gmm_bwd_half(torch, *args, "dx"), 50),
            "dw_ms": device_ms(torch, moe_gmm_bwd_half(torch, *args, "dw"), 50),
            "library_dx_ms": device_ms(torch, lib_dx, 50),
            "library_dw_ms": device_ms(torch, lib_dw, 50)}

    # B6's training form: the serving kernel plus a checkpoint every 32 steps
    for B, S, D, St, c_dt, h0, tag in ((4, 512, 8192, 16, bf16, False, "train,"),
                                       *((2, S, 200, 16, bf16, S % 2 == 1, "chunks,")
                                         for S in (1, 31, 32, 33, 333, 512))):
        case = f"{tag}B={B},S={S},D={D},St={St}" + (",h0" if h0 else "")
        a, b, c, h = ssm_scan_case(torch, B, S, D, St, c_dt, h0)
        y, h_last, ck = ssm_scan_train_cuda(a, b, c, h)
        sy, sh = ssm_scan_cuda(a, b, c, h)
        if not (torch.equal(y, sy) and torch.equal(h_last, sh)):
            fail(f"ssm_scan training kernel ({case}): y / h_last not bit-equal to the serving "
                 "kernel's")
        if not torch.equal(ck, ssm_scan_train_plain(a, b, c, h)[2]):
            fail(f"ssm_scan training kernel ({case}): checkpoints not bit-equal to the plain "
                 "version's")
        row = {"max_abs_err": 0.0, "bit_equal": "y,h_last (serving), h_ckpt (plain)"}
        if tag == "train,":
            row.update(timings(torch, lambda: ssm_scan_train_cuda(a, b, c, h),
                               lambda: ssm_scan_train_plain(a, b, c, h), None, 20, plain_iters=2))
            row["serving_ms"] = device_ms(torch, lambda: ssm_scan_cuda(a, b, c, h), 20)
            row["bound_ms"], row["bound_by"] = scan_bound_ms((a, b, c, h), (y, h_last, ck),
                                                             4.0 * a.numel())
            row["library_note"] = NO_SCAN_LIBRARY
        rows["ssm_scan_train"][case] = row

    for B, S, D, St, c_dt, h0, tag in ((4, 512, 8192, 16, bf16, False, "train,"),
                                       (2, 32, 128, 4, f32, False, "smoke,"),
                                       (2, 37, 200, 16, f32, True, "ragged,"),
                                       (3, 333, 50, 5, bf16, True, "ragged,")):
        case = f"{tag}B={B},S={S},D={D},St={St}" + (",h0" if h0 else "")
        a, b, c, h = ssm_scan_case(torch, B, S, D, St, c_dt, h0)
        gen = torch.Generator(device="cuda").manual_seed(12 + S + D)
        dy = torch.randn((B, S, D), generator=gen, device="cuda") * D ** -0.5
        dh_last = torch.randn((B, D, St), generator=gen, device="cuda")
        args = (a, b, c, h, dy, dh_last, ssm_scan_train_cuda(a, b, c, h)[2])
        got = ssm_scan_bwd_cuda(*args)
        ref = ssm_scan_bwd_plain(*args[:6])           # the whole chain re-run, no checkpoints
        tols = (F32_KERNEL_TOL, F32_KERNEL_TOL, KERNEL_TOL if c_dt == bf16 else F32_KERNEL_TOL,
                F32_KERNEL_TOL)
        err = max(check_kernel(torch, f"ssm_scan backward kernel ({case}) {n}", g, r, tol=tl)
                  for n, g, r, tl in zip(("da", "db", "dc", "dh0"), got, ref, tols))
        if got[2].dtype != c_dt:
            fail(f"ssm_scan backward kernel ({case}) stored dc as {got[2].dtype}")
        if not all(torch.equal(g, r) for i, (g, r) in enumerate(zip(got, ref)) if i != 2):
            fail(f"ssm_scan backward kernel ({case}): da / db / dh0 not bit-equal to the "
                 "plain version")
        if not all(torch.equal(g, r) for g, r in zip(got, ssm_scan_bwd_cuda(*args))):
            fail(f"ssm_scan backward kernel ({case}) differs between two calls")
        rows["ssm_scan_bwd"][case] = {"max_abs_err": err, "bit_equal": "da,db,dh0"}
        if tag != "train,":
            continue
        # the plain backwards loop over S in Python: a few calls suffice
        t = timings(torch, lambda a=args: ssm_scan_bwd_cuda(*a),
                    lambda a=args: ssm_scan_bwd_plain(*a), None, 10, plain_iters=2)
        bound_ms, bound_by = scan_bound_ms(args, got, 8.0 * a.numel())
        rows["ssm_scan_bwd"][case].update({**t, "bound_ms": bound_ms, "bound_by": bound_by,
                                           "library_note": NO_SCAN_LIBRARY})

    for B, S, R, h0, tag in ((4, 512, 2560, False, "train,"), (2, 32, 64, False, "smoke,"),
                             (2, 37, 200, True, "ragged,")):
        case = f"{tag}B={B},S={S},R={R}" + (",h0" if h0 else "")
        a, b, h = rglru_scan_case(torch, B, S, R, h0)
        hs, _ = rglru_scan_cuda(a, b, h)
        gen = torch.Generator(device="cuda").manual_seed(13 + S + R)
        dhs = torch.randn((B, S, R), generator=gen, device="cuda")
        dh_last = torch.randn((B, R), generator=gen, device="cuda")
        args = (a, hs, h, dhs, dh_last)
        got = rglru_scan_bwd_cuda(*args)
        ref = rglru_scan_bwd_plain(*args)
        err = max(check_kernel(torch, f"rglru_scan backward kernel ({case}) {n}", g, r,
                               tol=F32_KERNEL_TOL)
                  for n, g, r in zip(("da", "db", "dh0"), got, ref))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            fail(f"rglru_scan backward kernel ({case}) is not bit-equal to its plain version")
        if not all(torch.equal(g, r) for g, r in zip(got, rglru_scan_bwd_cuda(*args))):
            fail(f"rglru_scan backward kernel ({case}) differs between two calls")
        check_one_kernel(torch, f"rglru_scan backward kernel ({case})",
                         lambda a=args: rglru_scan_bwd_cuda(*a))
        t = timings(torch, lambda a=args: rglru_scan_bwd_cuda(*a),
                    lambda a=args: rglru_scan_bwd_plain(*a), None, 20, plain_iters=2)
        bound_ms, bound_by = scan_bound_ms(args, got, 3.0 * a.numel())
        rows["rglru_scan_bwd"][case] = {"max_abs_err": err, "bit_equal": True, **t,
                                        "bound_ms": bound_ms, "bound_by": bound_by,
                                        "library_note": NO_SCAN_LIBRARY}
    return rows


# -- phase 4: small reference --------------------------------------------------

def small_model_steps(torch, cfg, run, check, cpu, rng, errs: dict, tag: str) -> None:
    """Three captured steps of ``cfg`` on the card against the eager steps
    on the CPU: a paged decode step (B1; rows at three depths and an idle
    row), a per-slot prefill (B3; right-padded with ``valid_len`` for a
    dense arch, exact length for a MoE one, as the slot engine feeds them)
    and a per-slot decode step (B2, per-row form; an idle row).  A MoE
    arch's FFN runs B5 in each, and its idle rows route with the live ones,
    so every row is compared; so is every row of a dense arch (an idle
    row's attention is the mean of V in B1, B2 and their plain versions)."""
    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.serve.step import (make_decode_step, make_paged_decode_step,
                                        make_prefill_step)

    hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads

    # paged decode step (B1)
    B, ps, n_pt, P = 4, 8, 8, 32
    pages = [{kk: torch.as_tensor(rng.standard_normal((P, ps, Hkv, hd)), dtype=torch.float32)
              for kk in ("k", "v")} for _ in range(cfg.n_layers)]
    table = np.full((B, n_pt), -1, np.int32)
    table[0, :3], table[1, :1], table[2, :5] = [1, 2, 3], [9], [4, 5, 6, 7, 8]
    cache = {"len": torch.tensor([20, 3, 36, 0], dtype=torch.int32),
             "table": torch.as_tensor(table), "pages": pages}
    tokens = torch.tensor([[5], [17], [300], [0]], dtype=torch.int32)
    (ref, ref_cache), (got, got_cache) = run(make_paged_decode_step(cfg, ps), cpu, cache,
                                             tokens)
    errs[f"{tag}paged_decode"] = check("paged decode step", got, ref)
    for a, b in zip(got_cache["pages"], ref_cache["pages"]):
        check("paged decode step's K pages", a["k"], b["k"])

    # per-slot prefill (B3)
    sub = transformer.init_cache(cfg, 1, 64, per_slot=True, device="cpu")
    toks = rng.integers(1, 500, (1, 11 if cfg.n_experts else 16))
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32)}
    if not cfg.n_experts:
        batch["valid_len"] = torch.tensor(11, dtype=torch.int32)
    (ref, ref_sub), (got, got_sub) = run(make_prefill_step(cfg), cpu, sub, batch)
    errs[f"{tag}slot_prefill"] = check("per-slot prefill", got, ref)
    for a, b in zip(got_sub["layers"], ref_sub["layers"]):
        check("per-slot prefill's K", a["k"], b["k"])
        if not torch.equal(a["pos"].cpu(), b["pos"]):
            fail("small per-slot prefill wrote other positions on the card")

    # per-slot decode step (B2, per-row form)
    cache = transformer.init_cache(cfg, 4, 64, per_slot=True, device="cpu")
    lens = [20, 3, 36, 0]
    for lc in cache["layers"]:
        for kk in ("k", "v"):
            lc[kk] = torch.as_tensor(rng.standard_normal(lc[kk].shape), dtype=torch.float32)
        for b, n in enumerate(lens):
            lc["pos"][b, :n] = torch.arange(n, dtype=torch.int32)
    cache["len"] = torch.tensor(lens, dtype=torch.int32)
    (ref, ref_cache), (got, got_cache) = run(make_decode_step(cfg), cpu, cache, tokens)
    errs[f"{tag}slot_decode"] = check("per-slot decode step", got, ref)
    for a, b in zip(got_cache["layers"], ref_cache["layers"]):
        check("per-slot decode step's K", a["k"], b["k"])


def small_recurrent_steps(torch, cfg, run, check, cpu, rng, errs: dict, tag: str) -> None:
    """Two captured steps of a recurrent ``cfg`` on the card against the
    eager steps on the CPU: a per-slot prefill at the exact prompt length
    (21 tokens, past recurrentgemma's 16-token window) and a per-slot decode
    step from random states (one idle row).  B6 / B7 run in both.  Every
    row is compared: rows of a recurrent layer never meet, and an idle row's
    attention is the mean of V in B2 and in its plain version."""
    from repro_torch.models import transformer
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    sub = transformer.init_cache(cfg, 1, 64, per_slot=True, device="cpu")
    batch = {"tokens": torch.as_tensor(rng.integers(1, 500, (1, 21)), dtype=torch.int32)}
    (ref, ref_sub), (got, got_sub) = run(make_prefill_step(cfg), cpu, sub, batch)
    errs[f"{tag}slot_prefill"] = check("per-slot prefill", got, ref)
    for a, b in zip(got_sub["layers"], ref_sub["layers"]):
        for kk in ("h", "conv", "k"):
            if kk in a:
                check(f"per-slot prefill's {kk}", a[kk], b[kk])

    cache = transformer.init_cache(cfg, 4, 64, per_slot=True, device="cpu")
    lens = [20, 3, 36, 0]
    for lc in cache["layers"]:
        for kk in ("h", "conv", "k", "v"):
            if kk in lc:
                lc[kk] = torch.as_tensor(rng.standard_normal(lc[kk].shape), dtype=torch.float32)
        if "pos" in lc:            # a 16-entry ring: the last 16 positions of each row
            C = lc["pos"].shape[1]
            for b, n in enumerate(lens):
                p = torch.arange(max(0, n - C), n, dtype=torch.int32)
                lc["pos"][b, (p % C).long()] = p
    cache["len"] = torch.tensor(lens, dtype=torch.int32)
    tokens = torch.tensor([[5], [17], [300], [0]], dtype=torch.int32)
    (ref, ref_cache), (got, got_cache) = run(make_decode_step(cfg), cpu, cache, tokens)
    errs[f"{tag}slot_decode"] = check("per-slot decode step", got, ref)
    for a, b in zip(got_cache["layers"], ref_cache["layers"]):
        if "h" in a:
            check("per-slot decode step's state", a["h"], b["h"])


def small_phase(torch) -> None:
    """The smoke gemma-2b, granite-moe-1b-a400m, falcon-mamba-7b and
    recurrentgemma-2b configs in f32: captured steps on the card against
    the eager steps on the CPU (where every kernel takes its plain
    version); and a small LSTM.  The MoE checks run
    in f32 because routing is discontinuous: a near-tie at the top-k
    boundary flips an expert, and in f32 the two devices' router logits
    differ by ~1e-6, not bf16's ~1e-3."""
    import numpy as np
    from torch.utils import _pytree as pytree

    from repro_torch.api import compile as rt_compile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime

    def cuda(tree):
        return pytree.tree_map(lambda t: t.cuda(), tree)

    def check(what, got, ref):
        err = (got.cpu() - ref).abs().max().item()
        if not (got.shape == ref.shape and torch.isfinite(got).all() and err <= SMALL_TOL):
            fail(f"small {what} on the card disagrees with the CPU: max abs err {err}")
        return err

    rng = np.random.default_rng(0)
    errs = {}
    with Runtime(device="cuda") as rt:
        def run(step, *args):
            exe = rt_compile(step, *cuda(args), runtime=rt, jit_nodes=True,
                             host_mode="static")
            return step(*args), exe(*cuda(args))

        for arch, tag in (("gemma-2b", ""), ("granite-moe-1b-a400m", "moe_")):
            cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
            cpu = transformer.init_params(cfg, 0, device="cpu")
            reset_launch_counts()
            small_model_steps(torch, cfg, run, check, cpu, rng, errs, tag)
            counts = launch_counts()
            if cfg.n_experts and counts["moe_gmm"] < 3 * 3 * cfg.n_layers:
                fail(f"small: B5 launched {counts['moe_gmm']} times in three "
                     f"{cfg.n_layers}-layer MoE steps, fewer than {9 * cfg.n_layers}")
            check_kernel_forms(f"small {arch} (f32)", counts, "simt",
                               ("flash_attention",) + (("moe_gmm",) if cfg.n_experts else ()))
        for arch, tag, kind, kernel in (("falcon-mamba-7b", "mamba_", "ssm", "ssm_scan"),
                                        ("recurrentgemma-2b", "griffin_", "rglru",
                                         "rglru_scan")):
            cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
            cpu = transformer.init_params(cfg, 0, device="cpu")
            reset_launch_counts()
            small_recurrent_steps(torch, cfg, run, check, cpu, rng, errs, tag)
            want = 2 * cfg.layer_kinds().count(kind)
            if launch_counts()[kernel] < want:
                fail(f"small: {kernel} launched {launch_counts()[kernel]} times in two "
                     f"{arch} steps on the card, fewer than {want}")

        # a small LSTM, sequential and stacked (B4)
        from repro_torch.core.wavefront import (params_from_jax, sequential_lstm,
                                                stacked_wavefront_lstm)

        L, T, B, H = 2, 5, 4, 64
        stacked = params_from_jax({k: (rng.standard_normal(shape) * 0.1).astype(np.float32)
                                   for k, shape in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)),
                                                    ("b", (L, 4 * H)))}, device="cpu")
        per_layer = [{k: v[l].contiguous() for k, v in stacked.items()} for l in range(L)]
        xs = torch.as_tensor(rng.standard_normal((T, B, H)), dtype=torch.float32)
        ref, got = run(sequential_lstm, per_layer, xs)
        errs["lstm_sequential"] = check("sequential LSTM", got, ref)
        ref, got = run(lambda p, x: stacked_wavefront_lstm(p, x, L), stacked, xs)
        errs["lstm_stacked"] = check("stacked wavefront LSTM", got, ref)
    log("small: smoke gemma-2b, granite-moe-1b-a400m (moe_), falcon-mamba-7b (mamba_), "
        "recurrentgemma-2b (griffin_) and a 2x5 LSTM, f32, card vs CPU max abs err "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))


# -- phase 5: the paper's LSTM ------------------------------------------------

def wall_p50_ms(torch, fn, iters: int) -> float:
    """Host wall p50 of ``fn()`` followed by a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def lstm_sim_checks() -> dict:
    """The paper's §7.4 claim in the simulator under the H100 model: CPF's
    start order on the L x T recurrence DAG follows the anti-diagonals, and
    on the Table-1 "large" forward graph the mean start time per
    anti-diagonal strictly increases (4 executors, the card's 4 streams)."""
    from repro_torch.api import compile as rt_compile
    from repro_torch.core.cost_model import H100
    from repro_torch.core.simulate import SimConfig, simulate
    from repro_torch.core.wavefront import is_wavefront_order, recurrence_graph
    from repro_torch.models.paper_nets import (LSTM_LAYERS, PAPER_BATCH, PAPER_SIZES,
                                               paper_graph)
    from repro_torch.runtime import Runtime

    T, H = PAPER_SIZES["lstm"]["large"]
    B, L = PAPER_BATCH["lstm"], LSTM_LAYERS
    g = recurrence_graph(L, T, flops_per_cell=2 * 2 * B * H * 4 * H,
                         bytes_per_cell=3 * B * H * 4)
    with Runtime(device="cuda") as rt:
        exe = rt_compile(g, hw=H100, backend="sim", n_workers=L, reserved_workers=0,
                         runtime=rt)
        exe.profile_with(extra_configs=[(L, 1)])
        sched = exe.schedule
        cpf_ok = is_wavefront_order(sched.start_order(), g)
    pg = paper_graph("lstm", "large", training=False)
    res = simulate(pg, H100, SimConfig(n_executors=4, team_size=33))
    starts: dict[int, list[float]] = {}
    for ev in res.trace:
        if "diag" in pg[ev.op].meta:
            starts.setdefault(pg[ev.op].meta["diag"], []).append(ev.start)
    means = [sum(v) / len(v) for _, v in sorted(starts.items())]
    diag_ok = all(a < b for a, b in zip(means, means[1:]))
    log(f"lstm sim: recurrence {L}x{T} under H100: CPF start order is a wavefront: {cpf_ok} "
        f"({sched.n_executors} executors x team {sched.team_size}); paper graph lstm large "
        f"({len(pg)} nodes), 4 x 33: mean start per anti-diagonal increasing: {diag_ok} "
        f"(makespan {1e3 * res.makespan:.3f} ms modelled)")
    if not cpf_ok:
        fail("lstm sim: the CPF start order on the recurrence DAG is not a wavefront")
    if not diag_ok:
        fail("lstm sim: mean start times per anti-diagonal do not increase")
    return {"cpf_wavefront": cpf_ok, "diag_means_increase": diag_ok,
            "sim_executors": sched.n_executors, "sim_team": sched.team_size,
            "paper_graph_makespan_s": res.makespan}


def lstm_grad_check(torch, per_layer, stacked, xs, gen) -> dict:
    """The gradient of a mean squared error against a random target
    through the sequential and the stacked LSTM (B4's forward and its
    backward kernel on both), with respect to every weight and the input:
    finite, stacked within ``LSTM_TOL`` of sequential, and B4's forward /
    backward launches counted from 0 for each path (one each per cell
    call: L x T sequential, L + T - 1 stacked)."""
    from torch.utils import _pytree as pytree

    from repro_torch.core.wavefront import sequential_lstm, stacked_wavefront_lstm

    T, B, H = xs.shape
    L = len(per_layer)
    target = torch.randn((T, B, H), generator=gen, device="cuda")
    grads, launches, walls = {}, {}, {}
    for path, fn, tree in (("sequential", sequential_lstm, per_layer),
                           ("stacked", lambda p, x: stacked_wavefront_lstm(p, x, L), stacked)):
        leaves = [t.detach().requires_grad_(True) for t in pytree.tree_leaves(tree)]
        x = xs.detach().requires_grad_(True)
        params = pytree.tree_unflatten(leaves, pytree.tree_structure(tree))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = ((fn(params, x) - target) ** 2).mean()
        g = torch.autograd.grad(loss, leaves + [x])
        torch.cuda.synchronize()
        walls[path] = 1e3 * (time.perf_counter() - t0)
        counts = launch_counts()
        launches[path] = {k: counts[k] for k in ("lstm_cell", "lstm_cell_bwd")}
        want = L + T - 1 if path == "stacked" else L * T
        if launches[path] != {"lstm_cell": want, "lstm_cell_bwd": want}:
            fail(f"lstm grad {path}: B4 forward / backward launched {launches[path]}, "
                 f"not {want} / {want}")
        if not all(torch.isfinite(t).all() for t in g) or not torch.isfinite(loss):
            fail(f"lstm grad {path}: a non-finite gradient")
        grads[path] = g
    seq, stk = grads["sequential"], grads["stacked"]
    names = list(stacked)                       # Wx, Wh, b: per-layer leaves in this order
    pairs = [(f"{k}[{l}]", seq[len(names) * l + j], stk[j][l])
             for l in range(L) for j, k in enumerate(names)] + [("xs", seq[-1], stk[-1])]
    errs = {name: (a - b).abs().max().item() for name, a, b in pairs}
    scale = max(a.abs().max().item() for _, a, _ in pairs)
    worst = max(errs.values())
    if not worst <= LSTM_TOL:
        fail(f"lstm grad: stacked and sequential gradients disagree by {worst} > {LSTM_TOL}")
    log(f"lstm grad: d(mean squared error) w.r.t. Wx, Wh, b of {L} layers and xs: stacked "
        f"vs sequential max abs err {worst:.3e} (largest gradient {scale:.3e}); B4 forward / "
        f"backward launches {json.dumps(launches)}; host wall ms (forward + backward) "
        f"{json.dumps({k: round(v, 2) for k, v in walls.items()})}")
    return {"max_abs_err": worst, "largest": scale, "launches": launches, "wall_ms": walls}


def lstm_phase(torch) -> dict:
    """Table 1 "large" (T=40, H=1024, batch 64, 4 layers, f32) on the card:
    eager sequential and stacked forwards, then the sequential LSTM through
    Graphi's runtime.  Each path's B4 launches are counted over one forward
    with every count set to 0 just before it."""
    from repro_torch.api import compile as rt_compile
    from repro_torch.core.cost_model import H100
    from repro_torch.core.wavefront import sequential_lstm, stacked_wavefront_lstm
    from repro_torch.models.paper_nets import LSTM_LAYERS, PAPER_BATCH, PAPER_SIZES
    from repro_torch.runtime import Runtime

    out = {"sim": lstm_sim_checks()}
    T, H = PAPER_SIZES["lstm"]["large"]
    B, L = PAPER_BATCH["lstm"], LSTM_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacked = {k: torch.randn(shape, generator=gen, device="cuda") * 0.05
               for k, shape in (("Wx", (L, H, 4 * H)), ("Wh", (L, H, 4 * H)),
                                ("b", (L, 4 * H)))}
    per_layer = [{k: v[l].contiguous() for k, v in stacked.items()} for l in range(L)]
    xs = torch.randn((T, B, H), generator=gen, device="cuda")
    flops = 2 * 2 * L * T * B * H * 4 * H
    log(f"lstm: Table 1 large, {L} layers x {T} steps, batch {B}, {H} neurons, f32: "
        f"{flops / 1e9:.1f} GFLOP of GEMMs per forward")

    launches: dict[str, int] = {}

    def one(path, fn):
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        launches[path] = launch_counts()["lstm_cell"]
        return res

    seq = one("sequential", lambda: sequential_lstm(per_layer, xs))
    wav = one("stacked", lambda: stacked_wavefront_lstm(stacked, xs, L))
    if tuple(seq.shape) != (T, B, H) or not torch.isfinite(seq).all():
        fail(f"lstm: sequential output {tuple(seq.shape)} not finite {(T, B, H)}")
    err = (wav - seq).abs().max().item()
    if not err <= LSTM_TOL:
        fail(f"lstm: stacked and sequential disagree by {err} > {LSTM_TOL}")
    eager = {"sequential": wall_p50_ms(torch, lambda: sequential_lstm(per_layer, xs), 7),
             "stacked": wall_p50_ms(torch, lambda: stacked_wavefront_lstm(stacked, xs, L), 7)}
    log(f"lstm eager: stacked vs sequential max abs err {err:.3e}; host wall p50 "
        f"sequential {eager['sequential']:.3f} ms, stacked {eager['stacked']:.3f} ms")
    grad = lstm_grad_check(torch, per_layer, stacked, xs, gen)

    with Runtime(device="cuda") as rt:
        t0 = time.perf_counter()
        exe = rt_compile(sequential_lstm, per_layer, xs, hw=H100, runtime=rt, jit_nodes=True,
                         host_mode="static")
        n_exec = exe.host_plan().n_executors
        setup_s = time.perf_counter() - t0
        kinds: dict[str, int] = {}
        for nd in exe.graph.nodes:
            kinds[nd.kind] = kinds.get(nd.kind, 0) + 1
        if kinds.get("lstm_cell") != L * T or kinds.get("gemm") != 2 * L * T:
            fail(f"lstm runtime: captured graph has {kinds}, not {L * T} cells and "
                 f"{2 * L * T} GEMMs")
        log(f"lstm runtime: {len(exe.graph)} nodes {json.dumps(kinds)}, compiled in "
            f"{setup_s:.1f}s; profile {exe.profile.best_n_executors} executors x team "
            f"{exe.profile.best_team_size}; static plan on {n_exec} of {rt.n_workers} streams")
        inputs = exe.captured.bind((per_layer, xs))
        run = one("runtime", lambda: exe.execute_host(inputs, host_mode="static"))
        got = exe.captured.unflatten(run.outputs)
        rt_err = (got - seq).abs().max().item()
        if not rt_err <= LSTM_TOL:
            fail(f"lstm runtime: static plan and eager sequential disagree by {rt_err}")
        three, _ = three_way(torch, exe, n_exec, (per_layer, xs), "lstm", (T, B, H))
        walls = {f"static_{n}": wall_p50_ms(
                     torch, lambda n=n: exe.execute_host(inputs, n_executors=n,
                                                         host_mode="static"), 5)
                 for n in sorted({n_exec, 1})}
        prof = profile_static(torch, exe, n_exec, inputs, "lstm", 1, "forward")

        # where each cell was dispatched in a warm static run: capture names
        # the k-th cell call lstm_cell.k, and sequential_lstm calls them
        # layer-major
        traced = exe.execute_host(inputs, host_mode="static", collect_trace=True)
        torch.cuda.synchronize()
        per_diag: dict[int, list[float]] = {}
        for ev in traced.trace:
            if exe.graph[ev.op].kind == "lstm_cell":
                k = int(ev.op.rsplit(".", 1)[1])
                per_diag.setdefault(k // T + k % T, []).append(ev.start)
        means = [1e3 * sum(v) / len(v) for _, v in sorted(per_diag.items())]
        rising = all(a < b for a, b in zip(means, means[1:]))
        n_drops = sum(1 for a, b in zip(means, means[1:]) if b <= a)
    for path, n in launches.items():
        want = L + T - 1 if path == "stacked" else L * T
        if n != want:
            fail(f"lstm {path}: B4 launched {n} times in one forward, not {want}")
    log(f"lstm runtime: static vs eager max abs err {rt_err:.3e}; host wall p50 "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in walls.items())
        + f"; B4 launches per forward {json.dumps(launches)}")
    log(f"lstm wavefront on the card (finding, not a gate): mean dispatch ms per "
        f"anti-diagonal {[round(m, 3) for m in means]}; increasing: {rising} "
        f"({n_drops} of {len(means) - 1} steps do not rise)")
    out.update({"grad": grad, "eager_ms": eager, "stacked_err": err, "runtime_err": rt_err,
                "nodes": len(exe.graph), "kinds": kinds, "n_executors": n_exec,
                "profile_config": [exe.profile.best_n_executors, exe.profile.best_team_size],
                "runtime_ms": walls, "three_way": three, "device_profile": prof,
                "launches": launches, "diag_dispatch_ms": means, "diag_rising": rising,
                "compile_s": setup_s})
    return out


# -- phase 6: train ------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 3       # full-width gemma-2b train phase
SMALL_TRAIN_B, SMALL_TRAIN_S = 2, 32            # the f32 smoke config's step


# the f32 smoke configs the small train phase runs, and the tag of each
SMALL_TRAIN_ARCHS = (("gemma-2b", "gemma"), ("granite-moe-1b-a400m", "moe"),
                     ("falcon-mamba-7b", "mamba"), ("recurrentgemma-2b", "griffin"))


def train_launches(cfg, remat: bool) -> dict:
    """The launches of each training kernel in one loss + gradient of
    ``cfg``: per attention layer B3's training forward and its backward,
    per FFN of a MoE arch three B5 products and three backwards, per Mamba
    layer one B6 training forward and one backward, per RG-LRU layer one
    B7 and one backward; remat runs every forward twice.  Every other
    kernel (B3's and B6's serving forms included): 0."""
    kinds = cfg.layer_kinds()
    fwd = 2 if remat else 1
    attn, ssm, rglru = kinds.count("attn"), kinds.count("ssm"), kinds.count("rglru")
    moe = 3 * (attn + rglru) if cfg.n_experts else 0
    return {"flash_attention_train": fwd * attn, "flash_attention_bwd": attn,
            "moe_gmm": fwd * moe, "moe_gmm_bwd": moe, "ssm_scan_train": fwd * ssm,
            "ssm_scan_bwd": ssm, "rglru_scan": fwd * rglru, "rglru_scan_bwd": rglru}


def check_train_launches(what: str, counts: dict, want: dict) -> None:
    """Exactly ``want`` launches of each training kernel and none of any
    other kernel (forms aside)."""
    names = {k for k in counts if "." not in k} | set(want)
    got = {k: counts.get(k, 0) for k in names}
    expect = {k: want.get(k, 0) for k in names}
    if got != expect:
        fail(f"{what}: kernel launches {got}, not {expect}")


# the kernels with forms, on a training path
TRAIN_FORMS = ("flash_attention_train", "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd")


def small_train_phase(torch) -> dict:
    """The smoke gemma-2b, granite-moe-1b-a400m, falcon-mamba-7b and
    recurrentgemma-2b configs in f32, each: the loss (for granite, its MoE
    load-balancing loss too) and every gradient of one batch on the card
    against the CPU (every kernel's plain version there) within
    ``SMALL_TOL``, the card's launches of each training kernel exact
    (``train_launches``); one ``make_train_step`` step on the card (finite
    loss and gradient norm); and ``compile_lm_loss(grad=True,
    backend="host")`` on the card: the captured loss + gradient graph run
    as a static plan, under the dynamic scheduler and through sequential
    ``Graph.execute``, every output bit-identical across the three and
    within ``SMALL_TOL`` of eager autograd.  Every B3 and B5 launch,
    forward and backward, takes the SIMT (f32) form.  Returns a dict per
    arch tag."""
    out = {}
    for arch, tag in SMALL_TRAIN_ARCHS:
        t0 = time.perf_counter()
        out[tag] = small_train_arch(torch, arch, tag)
        out[tag]["seconds"] = time.perf_counter() - t0
    return out


def small_train_arch(torch, arch: str, tag: str) -> dict:
    import numpy as np
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import Runtime
    from repro_torch.train.step import (TrainStepConfig, compile_lm_loss, lm_loss_fn,
                                        make_train_step, value_and_grad)

    cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    B, S = SMALL_TRAIN_B, SMALL_TRAIN_S
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :S].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    cpu = transformer.init_params(cfg, 0, device="cpu")

    def cuda(tree):
        return pytree.tree_map(lambda t: t.cuda(), tree)

    vg = value_and_grad(lambda p, b: model_api.lm_loss(cfg, p, b), has_aux=True)
    (loss_cpu, parts_cpu), g_cpu = vg(cpu, batch)
    reset_launch_counts()
    (loss_gpu, parts_gpu), g_gpu = vg(cuda(cpu), cuda(batch))
    torch.cuda.synchronize()
    counts = launch_counts()
    errs = [(loss_gpu.cpu() - loss_cpu).abs().item(),
            (parts_gpu["aux"].cpu() - parts_cpu["aux"]).abs().item()] + [
        (a.cpu() - b).abs().max().item()
        for a, b in zip(pytree.tree_leaves(g_gpu), pytree.tree_leaves(g_cpu))]
    if not (all(bool(torch.isfinite(t).all()) for t in pytree.tree_leaves(g_gpu))
            and max(errs) <= SMALL_TOL):
        fail(f"small train {arch}: loss / aux / gradients on the card disagree with the CPU "
             f"by {max(errs)} (limit {SMALL_TOL})")
    if cfg.n_experts and not parts_gpu["aux"].item() > 0:
        fail(f"small train {arch}: MoE aux {parts_gpu['aux'].item()} is not positive")
    check_train_launches(f"small train {arch}", counts, train_launches(cfg, remat=False))
    check_kernel_forms(f"small train {arch} (f32)", counts, "simt",
                       [k for k in TRAIN_FORMS if counts[k]])

    shape = ShapeSpec("small_train", S, B, "train")
    with Runtime(device="cuda") as rt:
        t0 = time.perf_counter()
        exe = compile_lm_loss(cfg, shape, backend="host", grad=True, runtime=rt,
                              device="cuda", jit_nodes=True, host_mode="static")
        n_exec = exe.host_plan().n_executors
        setup_s = time.perf_counter() - t0
        fwd_nodes = len(compile_lm_loss(cfg, shape, backend="sim", runtime=rt,
                                        device="cuda").graph)
        kinds: dict[str, int] = {}
        for nd in exe.graph.nodes:
            kinds[nd.kind] = kinds.get(nd.kind, 0) + 1
        n_attn = cfg.layer_kinds().count("attn")
        if kinds.get("attention", 0) != 2 * n_attn or len(exe.graph) <= fwd_nodes:
            fail(f"small train graph {arch}: {len(exe.graph)} nodes {kinds} (forward graph "
                 f"{fwd_nodes}): not a forward + backward with {2 * n_attn} attention nodes")
        # a scan and its backward each one node a layer (B6 in its training form)
        for kind, fwd in (("ssm", "ssm_scan_train"), ("rglru", "rglru_scan")):
            n = cfg.layer_kinds().count(kind)
            if n and not kinds.get(fwd) == kinds.get(f"{kind}_scan_bwd") == n:
                fail(f"small train graph {arch}: {kinds} has not {n} {fwd} and "
                     f"{kind}_scan_bwd nodes")
        inputs = exe.captured.bind((cuda(cpu), cuda(batch)))
        outs = {}
        for mode in ("static", "dynamic"):
            res = exe.execute_host(inputs, n_executors=n_exec, host_mode=mode)
            outs[mode] = pytree.tree_leaves(exe.captured.unflatten(res.outputs))
        outs["sequential"] = pytree.tree_leaves(exe.captured.unflatten(exe.graph.execute(inputs)))
        torch.cuda.synchronize()
    for mode in ("static", "dynamic"):
        if not all(torch.equal(a, b) for a, b in zip(outs[mode], outs["sequential"])):
            fail(f"small train graph {arch}: {mode} outputs differ from sequential")
    eager = pytree.tree_leaves(value_and_grad(lm_loss_fn(cfg))(cuda(cpu), cuda(batch)))
    graph_err = max((a - b).abs().max().item() for a, b in zip(outs["sequential"], eager))
    if len(eager) != len(outs["sequential"]) or not graph_err <= SMALL_TOL:
        fail(f"small train graph {arch}: outputs {graph_err} from eager autograd")
    # one train step on the card (it updates its state in place: a copy)
    state = {"params": pytree.tree_map(lambda t: t.clone(), cuda(cpu))}
    state.update(adamw_init(state["params"]))
    state, metrics = make_train_step(cfg, TrainStepConfig(remat=True))(state, batch)
    torch.cuda.synchronize()
    if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])):
        fail(f"small train {arch}: one step gave loss {metrics['loss']}, "
             f"grad norm {metrics['grad_norm']}")
    log(f"small train: smoke {arch} f32, B={B} S={S}: loss, aux + {len(errs) - 2} gradients "
        f"card vs CPU max abs err {max(errs):.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; one train step loss "
        f"{float(metrics['loss']):.4f}; loss+grad graph {len(exe.graph)} nodes "
        f"{json.dumps(kinds)} (forward {fwd_nodes}), compiled in {setup_s:.1f}s, static / "
        f"dynamic / sequential bit-identical on {n_exec} streams, vs eager autograd "
        f"{graph_err:.3e}")
    return {"max_abs_err": max(errs), "graph_nodes": len(exe.graph), "forward_nodes": fwd_nodes,
            "graph_kinds": kinds, "graph_vs_eager": graph_err, "n_executors": n_exec,
            "launches": {k: v for k, v in counts.items() if v}}


def bit_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def train_phase(torch) -> dict:
    """Full-width gemma-2b (random weights from seed 0) through
    ``make_train_step`` and the ``Trainer``: TRAIN_STEPS AdamW steps on the
    bigram stream at B=4, S=512, remat on, a checkpoint at the last step in
    a temporary directory, restored and compared bit for bit (bf16 params,
    f32 moments, the step).  Gates: every loss and gradient norm finite (a
    finite global norm means every gradient is), and per step exactly
    2 x 18 B3 training-forward launches (remat runs each layer's forward
    twice) and 18 backward launches, all on the tensor-core forms."""
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models.api import model_train_flops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("gemma-2b")
    B, S, steps = TRAIN_B, TRAIN_S, TRAIN_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tcfg = TrainStepConfig(remat=True, adamw=AdamWConfig(lr=1e-4), warmup_steps=1,
                           total_steps=steps)
    state = init_train_state(cfg, 0, tcfg.adamw, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(state)) / 1e9
    log(f"train: gemma-2b {cfg.n_layers}x{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd "
        f"{cfg.resolved_head_dim} ff {cfg.d_ff} vocab {cfg.vocab_size}: {n_params / 1e9:.3f}B "
        f"params, state (bf16 params + f32 moments) {state_gb:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f}s")
    step = make_train_step(cfg, tcfg)
    per_step: list[dict] = []

    def counted(st, batch):
        before = launch_counts()
        out = step(st, batch)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in
                         ("flash_attention_train", "flash_attention_train.mma",
                          "flash_attention_bwd", "flash_attention_bwd.mma")})
        return out

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      kind="bigram"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        if free_gb < 1.5 * state_gb:
            fail(f"train: {free_gb:.1f} GB free under {tmp}, the checkpoint needs "
                 f"{state_gb:.1f} GB")
        mgr = CheckpointManager(tmp, keep=1)
        trainer = Trainer(counted, state, data.batch,
                          TrainerConfig(total_steps=steps, checkpoint_every=steps,
                                        log_every=1),
                          checkpoint=mgr)
        reset_launch_counts()
        t0 = time.perf_counter()
        report = trainer.run()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        totals = launch_counts()
        recs = [r for r in report.history if "loss" in r]
        if report.restarts or len(recs) != steps:
            fail(f"train: {report.restarts} restarts, {len(recs)} of {steps} steps logged")
        for r in recs:
            if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
                fail(f"train: step {r['step']} loss {r['loss']} grad norm {r['grad_norm']}")
        L = cfg.n_layers
        for i, c in enumerate(per_step):
            if c != {"flash_attention_train": 2 * L, "flash_attention_train.mma": 2 * L,
                     "flash_attention_bwd": L, "flash_attention_bwd.mma": L}:
                fail(f"train step {i}: B3 launches {c}, not {2 * L} training forwards and "
                     f"{L} backwards, all mma")
        check_kernel_forms("train", totals, "mma",
                           ("flash_attention_train", "flash_attention_bwd"))
        # the checkpoint the trainer wrote at the last step, restored
        t1 = time.perf_counter()
        latest = mgr.latest()
        _, restored = mgr.restore(trainer.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        pairs = list(zip(pytree.tree_leaves(restored), pytree.tree_leaves(trainer.state)))
        if latest != steps or not all(bit_equal(torch, a, b) for a, b in pairs):
            fail(f"train: checkpoint of step {latest} did not restore bit for bit")
        ckpt_gb = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file()) / 1e9
        del restored, pairs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # where a step's time goes: one more step (batch of step 0) under the
    # profiler, and the AdamW update alone (zero bf16 grads, CUDA events)
    batch = data.batch(0)
    prof = profile_calls(torch, lambda: step(trainer.state, batch), "train", 1, "train step")
    from repro_torch.optim.adamw import adamw_update

    zeros = pytree.tree_map(torch.zeros_like, trainer.state["params"])
    opt = {k: trainer.state[k] for k in ("m", "v", "step")}
    adamw_ms = cuda_ms(lambda: adamw_update(zeros, trainer.state["params"], opt, tcfg.adamw),
                       2, warmup=1)
    del zeros
    log(f"train: one AdamW update of the {n_params / 1e9:.3f}B parameters takes "
        f"{adamw_ms:.1f} ms (CUDA events, host launch included)")
    times = [r["time_s"] for r in recs]
    p50 = statistics.median(times)
    tokens = B * S
    flops = model_train_flops(cfg, ShapeSpec("train", S, B, "train"))
    res = {"steps": steps, "batch": B, "seq": S, "remat": True, "n_params": n_params,
           "losses": [r["loss"] for r in recs], "grad_norms": [r["grad_norm"] for r in recs],
           "step_s": times, "ms_per_step_p50": 1e3 * p50, "tokens_per_s": tokens / p50,
           "model_tflops_per_s": flops / p50 / 1e12, "peak_memory_gb": peak_gb,
           "state_gb": state_gb, "checkpoint_gb": ckpt_gb, "run_s": run_s,
           "restore_s": restore_s, "launches_per_step": per_step, "device_profile": prof,
           "adamw_ms": adamw_ms,
           "launches": {"flash_attention": totals["flash_attention_train"],
                        "flash_attention.mma": totals["flash_attention_train.mma"],
                        "flash_attention_bwd": totals["flash_attention_bwd"],
                        "flash_attention_bwd.mma": totals["flash_attention_bwd.mma"]}}
    log(f"train: {steps} AdamW steps, B={B} S={S}, remat: losses "
        f"{[round(x, 4) for x in res['losses']]}, grad norms "
        f"{[round(x, 4) for x in res['grad_norms']]}; ms/step {[round(1e3 * t, 1) for t in times]}"
        f" (p50 {res['ms_per_step_p50']:.1f}), {res['tokens_per_s']:.0f} tokens/s, "
        f"{res['model_tflops_per_s']:.1f} TFLOP/s by 6ND; peak memory {peak_gb:.2f} GB; "
        f"B3 per step {per_step[0]}; checkpoint {ckpt_gb:.1f} GB restored bit-exact "
        f"in {restore_s:.1f}s (run incl. save {run_s:.1f}s)")
    del trainer, state
    torch.cuda.empty_cache()
    return res


# the families trained at B=4, S=512 after gemma-2b: (arch, tag, layers);
# falcon-mamba-7b's 64 layers (7.27 B parameters, ~87 GB of bf16 weights and
# gradients and f32 AdamW moments) are cut to FALCON_TRAIN_LAYERS, width kept:
# 32 layers peaked at 53.6 GB on an H100 80GB HBM3 and each layer adds ~1.26
# GB (105 M parameters at 12 bytes), so 44 leave ~11 GB of the card free
FALCON_TRAIN_LAYERS = 44
FAMILY_TRAIN = (("granite-moe-1b-a400m", "moe_train", None),
                ("recurrentgemma-2b", "griffin_train", None),
                ("falcon-mamba-7b", "mamba_train", FALCON_TRAIN_LAYERS))


def family_train_phase(torch, arch: str, tag: str, n_layers) -> dict:
    """``arch`` at full width (its published config; depth cut to
    ``n_layers`` where given), random weights from seed 0, through
    ``make_train_step`` and the ``Trainer``: TRAIN_STEPS AdamW steps on
    the bigram stream at B=4, S=512, remat on (no checkpoint: the gemma
    phase holds save and restore).  Gates: every loss, MoE aux and
    gradient norm finite; a MoE arch's loss equal to ce + 0.01·aux, with
    aux > 0; per step exactly the launches ``train_launches(cfg,
    remat=True)`` gives (B3, B5, B6, B7 forward twice and backward once a
    layer) and no other kernel's; every B3 and B5 launch, forward and
    backward, on the tensor-core form.  Prints ms/step p50, tokens/s, peak
    memory and where one more step's device time goes (``torch.profiler``)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models.api import model_train_flops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None and n_layers != cfg.n_layers:
        cfg = cfg.reduced(n_layers=n_layers)
    B, S, steps = TRAIN_B, TRAIN_S, TRAIN_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tcfg = TrainStepConfig(remat=True, adamw=AdamWConfig(lr=1e-4), warmup_steps=1,
                           total_steps=steps)
    state = init_train_state(cfg, 0, tcfg.adamw, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(state)) / 1e9
    log(f"{tag}: {arch} {cfg.n_layers} of {full_layers} layers x d_model {cfg.d_model}, "
        f"kinds {sorted(set(cfg.layer_kinds()))}: {n_params / 1e9:.3f}B params, state "
        f"(bf16 params + f32 moments) {state_gb:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f}s")
    step = make_train_step(cfg, tcfg)
    per_step: list[dict] = []

    def counted(st, batch):
        before = launch_counts()
        out = step(st, batch)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      kind="bigram"))
    trainer = Trainer(counted, state, data.batch,
                      TrainerConfig(total_steps=steps, checkpoint_every=steps, log_every=1))
    reset_launch_counts()
    t0 = time.perf_counter()
    report = trainer.run()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    totals = launch_counts()
    recs = [r for r in report.history if "loss" in r]
    if report.restarts or len(recs) != steps:
        fail(f"{tag}: {report.restarts} restarts, {len(recs)} of {steps} steps logged")
    for r in recs:
        if not all(math.isfinite(r[k]) for k in ("loss", "ce", "aux", "grad_norm")):
            fail(f"{tag}: step {r['step']} loss {r['loss']} ce {r['ce']} aux {r['aux']} "
                 f"grad norm {r['grad_norm']}")
        if cfg.n_experts and not (r["aux"] > 0 and math.isclose(
                r["loss"], r["ce"] + 0.01 * r["aux"], rel_tol=1e-6, abs_tol=1e-6)):
            fail(f"{tag}: step {r['step']} loss {r['loss']} is not ce {r['ce']} + 0.01 x "
                 f"aux {r['aux']} (aux > 0)")
    want = {k: v for k, v in train_launches(cfg, remat=True).items() if v}
    for i, c in enumerate(per_step):
        check_train_launches(f"{tag} step {i}", c, want)
    check_kernel_forms(tag, totals, "mma", [k for k in TRAIN_FORMS if totals[k]])
    batch = data.batch(0)
    prof = profile_calls(torch, lambda: step(trainer.state, batch), tag, 1, "train step")
    times = [r["time_s"] for r in recs]
    p50 = statistics.median(times)
    flops = model_train_flops(cfg, ShapeSpec("train", S, B, "train"))
    res = {"arch": arch, "layers": cfg.n_layers, "full_layers": full_layers, "steps": steps,
           "batch": B, "seq": S, "remat": True, "n_params": n_params,
           "losses": [r["loss"] for r in recs], "ce": [r["ce"] for r in recs],
           "aux": [r["aux"] for r in recs], "grad_norms": [r["grad_norm"] for r in recs],
           "step_s": times, "ms_per_step_p50": 1e3 * p50, "tokens_per_s": B * S / p50,
           "model_tflops_per_s": flops / p50 / 1e12, "peak_memory_gb": peak_gb,
           "state_gb": state_gb, "run_s": run_s, "launches_per_step": per_step,
           "device_profile": prof, "launches": {k: v for k, v in totals.items() if v}}
    # B3's training forwards count on the kernels line as its forward's, as
    # gemma-2b's do
    for form in ("", ".mma"):
        if totals[f"flash_attention_train{form}"]:
            res["launches"][f"flash_attention{form}"] = totals[f"flash_attention_train{form}"]
    log(f"{tag}: {steps} AdamW steps, B={B} S={S}, remat: losses "
        f"{[round(x, 4) for x in res['losses']]}, aux {[round(x, 4) for x in res['aux']]}, "
        f"grad norms {[round(x, 4) for x in res['grad_norms']]}; ms/step "
        f"{[round(1e3 * t, 1) for t in times]} (p50 {res['ms_per_step_p50']:.1f}), "
        f"{res['tokens_per_s']:.0f} tokens/s, {res['model_tflops_per_s']:.1f} TFLOP/s by 6ND; "
        f"peak memory {peak_gb:.2f} GB; launches per step {per_step[0]}")
    del trainer, state
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 7: serve ------------------------------------------------------------

def launch_counts() -> dict:
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda, lstm_cell_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda, moe_gmm_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda, rglru_scan_cuda
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda, ssm_scan_cuda,
                                              ssm_scan_train_cuda)

    return {"paged_decode_attention": paged_decode_attention_cuda.launches,
            "decode_attention": decode_attention_cuda.launches,
            "decode_attention.shared": decode_attention_cuda.launches_by_form["shared"],
            "decode_attention.per_row": decode_attention_cuda.launches_by_form["per_row"],
            "flash_attention": flash_attention_cuda.launches,
            "flash_attention.mma": flash_attention_cuda.launches_by_path["mma"],
            "flash_attention.simt": flash_attention_cuda.launches_by_path["simt"],
            "flash_attention_train": flash_attention_train_cuda.launches,
            "flash_attention_train.mma": flash_attention_train_cuda.launches_by_path["mma"],
            "flash_attention_train.simt": flash_attention_train_cuda.launches_by_path["simt"],
            "flash_attention_bwd": flash_attention_bwd_cuda.launches,
            "flash_attention_bwd.mma": flash_attention_bwd_cuda.launches_by_path["mma"],
            "flash_attention_bwd.simt": flash_attention_bwd_cuda.launches_by_path["simt"],
            "lstm_cell": lstm_cell_cuda.launches,
            "lstm_cell_bwd": lstm_cell_bwd_cuda.launches,
            "moe_gmm": moe_gmm_cuda.launches,
            "moe_gmm.mma": moe_gmm_cuda.launches_by_path["mma"],
            "moe_gmm.simt": moe_gmm_cuda.launches_by_path["simt"],
            "moe_gmm_bwd": moe_gmm_bwd_cuda.launches,
            "moe_gmm_bwd.mma": moe_gmm_bwd_cuda.launches_by_path["mma"],
            "moe_gmm_bwd.simt": moe_gmm_bwd_cuda.launches_by_path["simt"],
            "ssm_scan": ssm_scan_cuda.launches,
            "ssm_scan_train": ssm_scan_train_cuda.launches,
            "ssm_scan_bwd": ssm_scan_bwd_cuda.launches,
            "rglru_scan": rglru_scan_cuda.launches,
            "rglru_scan_bwd": rglru_scan_bwd_cuda.launches}


def check_kernel_forms(what: str, launches: dict, form: str, kernels) -> None:
    """Every launch of each named kernel (B3, its backward, B5) took
    ``form``: ``"mma"`` (tensor cores) for the full-width bf16 paths,
    ``"simt"`` for f32."""
    for name in kernels:
        if launches[name] <= 0 or launches[f"{name}.{form}"] != launches[name]:
            fail(f"{what}: {launches[f'{name}.{form}']} of {launches[name]} {name} launches "
                 f"took the {form} form")


def reset_launch_counts() -> None:
    """Every kernel's count to 0, just before a path is driven."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda, lstm_cell_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd_cuda, moe_gmm_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda, rglru_scan_cuda
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd_cuda, ssm_scan_cuda,
                                              ssm_scan_train_cuda)

    paged_decode_attention_cuda.launches = 0
    decode_attention_cuda.launches = 0
    decode_attention_cuda.launches_by_form = {"shared": 0, "per_row": 0}
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_path = {"mma": 0, "simt": 0}
    flash_attention_train_cuda.launches = 0
    flash_attention_train_cuda.launches_by_path = {"mma": 0, "simt": 0}
    flash_attention_bwd_cuda.launches = 0
    flash_attention_bwd_cuda.launches_by_path = {"mma": 0, "simt": 0}
    lstm_cell_cuda.launches = 0
    lstm_cell_bwd_cuda.launches = 0
    moe_gmm_cuda.launches = 0
    moe_gmm_cuda.launches_by_path = {"mma": 0, "simt": 0}
    moe_gmm_bwd_cuda.launches = 0
    moe_gmm_bwd_cuda.launches_by_path = {"mma": 0, "simt": 0}
    ssm_scan_cuda.launches = 0
    ssm_scan_train_cuda.launches = 0
    ssm_scan_bwd_cuda.launches = 0
    rglru_scan_cuda.launches = 0
    rglru_scan_bwd_cuda.launches = 0


def build_model(torch, n_layers: int):
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

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
    return cfg, params


def check_streams(done, n: int, new_tokens: int, vocab: int, what: str) -> None:
    if len(done) != n or any(not r.done or len(r.output) != new_tokens for r in done):
        fail(f"{what}: {len(done)} requests came back, not {n} complete ones")
    if any(not (0 <= t < vocab) for r in done for t in r.output):
        fail(f"{what}: a token id outside the vocabulary")


def paged_serve_phase(torch, cfg, params) -> dict:
    import numpy as np

    import repro_torch
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, Request, ServeConfig

    rt = Runtime(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(
        cfg, params, ServeConfig(max_batch=8, max_len=1024),
        paged=PagedConfig(page_size=16, prefill_chunk=128), device="cuda", runtime=rt)
    setup_s = time.perf_counter() - t0
    log(f"paged: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
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

    reset_launch_counts()                         # count the main path's launches only
    t_serve = time.perf_counter()
    eng.submit(Request(0, shared_a.astype(np.int32), max_new_tokens=new_tokens))
    while eng.prefills or eng.pending:            # request 0's prefix registers first
        eng.step()
    for i, p in enumerate([shared_b] + others, start=1):
        eng.submit(Request(i, p.astype(np.int32), max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = launch_counts()

    check_streams(done, 8, new_tokens, V, "paged")
    st = eng.stats()
    if st["n_shared_pages"] < 8 or st["n_cow_copies"] < 1:
        fail(f"paged: prefix sharing did not happen ({st})")
    need = cfg.n_layers * st["n_decode_steps"]
    if launches["paged_decode_attention"] < need:
        fail(f"paged: B1 launched {launches['paged_decode_attention']} times, < {need} "
             f"({cfg.n_layers} layers x {st['n_decode_steps']} decode steps)")
    n_tok = sum(len(r.output) for r in done)
    p50 = statistics.median(eng.decode_step_s)
    log(f"paged: {len(done)} requests, {n_tok} tokens in {wall:.2f}s = {n_tok / wall:.1f} tok/s; "
        f"decode step p50 {1e3 * p50:.1f} ms over {st['n_decode_steps']} steps; "
        f"launches {json.dumps(launches)}; {json.dumps(st)}")
    log(f"paged: first tokens {[r.output[:4] for r in done]}")

    three, inputs = three_way_decode(torch, eng, rng)
    trace = profile_decode(torch, eng, inputs, "paged")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"paged: peak device memory {peak_gb:.2f} GB")
    rt.close()
    return {"trace": trace, "peak_mem_gb": peak_gb, "launches": launches, "tokens": n_tok,
            "wall_s": wall, "tok_per_s": n_tok / wall, "decode_p50_ms": 1e3 * p50,
            "n_decode_steps": st["n_decode_steps"], "n_executors": eng.n_executors,
            "team_size": eng.profile.best_team_size, "peak_pages": st["peak_pages"],
            "stats": st, "setup_s": eng.setup_s, "engine_build_s": setup_s,
            "three_way": three}


def slot_serve_phase(torch, cfg, params) -> dict:
    """The per-slot ContinuousEngine: 8 requests, 4 then 4 more after one
    step, so the second four's prefills overlap decode steps."""
    import numpy as np

    import repro_torch
    from repro_torch.runtime import Runtime
    from repro_torch.serve import ContinuousEngine, Request, ServeConfig

    rt = Runtime(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   device="cuda", runtime=rt)
    if not isinstance(eng, ContinuousEngine):
        fail(f"slot: serve_engine gave {type(eng).__name__}, not the ContinuousEngine")
    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    lens = (64, 512, 200, 333, 97, 450, 128, 300)
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    t1 = time.perf_counter()
    eng.warmup(lens)                              # capture the prompt buckets up front
    eng.setup_s["prefill_capture"] = time.perf_counter() - t1
    setup_s = time.perf_counter() - t0
    log(f"slot: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
        f"n_executors={eng.n_executors} team_size={eng.profile.best_team_size} "
        f"decode_host_mode={eng.decode_host_mode} decode nodes={len(eng._decode_exe.graph)} "
        f"prefill buckets {sorted(eng._prefill_exes)}")
    new_tokens = 32

    reset_launch_counts()
    t_serve = time.perf_counter()
    for i in range(4):
        eng.submit(Request(i, prompts[i], max_new_tokens=new_tokens))
    eng.step()
    for i in range(4, 8):
        eng.submit(Request(i, prompts[i], max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = launch_counts()

    check_streams(done, 8, new_tokens, V, "slot")
    st = eng.stats()
    if st["n_overlapped_prefills"] < 1:
        fail(f"slot: no admission overlapped a decode step ({st})")
    need_b2 = cfg.n_layers * st["n_decode_steps"]
    need_b3 = cfg.n_layers * len(prompts)
    if launches["decode_attention.per_row"] < need_b2:
        fail(f"slot: B2 (per-row form) launched {launches['decode_attention.per_row']} times, "
             f"< {need_b2} ({cfg.n_layers} layers x {st['n_decode_steps']} decode steps)")
    if launches["flash_attention"] < need_b3:
        fail(f"slot: B3 launched {launches['flash_attention']} times, < {need_b3} "
             f"({cfg.n_layers} layers x {len(prompts)} admissions)")
    n_tok = sum(len(r.output) for r in done)
    p50 = statistics.median(eng.decode_step_s)
    log(f"slot: {len(done)} requests, {n_tok} tokens in {wall:.2f}s = {n_tok / wall:.1f} tok/s; "
        f"decode step p50 {1e3 * p50:.1f} ms over {st['n_decode_steps']} steps; "
        f"launches {json.dumps(launches)}; {json.dumps(st)}")
    log(f"slot: first tokens {[r.output[:4] for r in done]}")

    # the out-of-place slot updates: one insert copies every layer's K/V
    from repro_torch.models import transformer

    copy_ms = {"insert": device_ms(torch, lambda: transformer.cache_insert_slot(
                   cfg, eng.cache, eng._zero_sub_cache, 3), 10),
               "evict": device_ms(torch, lambda: transformer.cache_evict_slot(
                   cfg, eng.cache, 3), 10)}
    log(f"slot: device ms per cache_insert_slot {copy_ms['insert']:.4f}, "
        f"per cache_evict_slot {copy_ms['evict']:.4f}")
    args = slot_decode_args(torch, eng)
    three, inputs = three_way(torch, eng._decode_exe, eng.n_executors, args, "slot",
                              (eng.capacity, cfg.padded_vocab))
    trace = profile_decode(torch, eng, inputs, "slot")
    # one 512-token admission prefill (18 B3 launches): its device time
    exe = eng._prefill_exe(len(prompts[1]))
    prefill_trace = profile_static(
        torch, exe, eng.n_executors,
        exe.captured.bind((eng.params, eng._zero_sub_cache, eng._prefill_batch(prompts[1]))),
        "slot prefill", 2, f"{len(prompts[1])}-token prefill")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"slot: peak device memory {peak_gb:.2f} GB")
    rt.close()
    return {"trace": trace, "prefill_trace": prefill_trace, "peak_mem_gb": peak_gb,
            "launches": launches, "tokens": n_tok,
            "wall_s": wall, "tok_per_s": n_tok / wall, "decode_p50_ms": 1e3 * p50,
            "decode_step_ms": [1e3 * x for x in eng.decode_step_s],
            "n_decode_steps": st["n_decode_steps"], "n_executors": eng.n_executors,
            "team_size": eng.profile.best_team_size, "stats": st, "setup_s": eng.setup_s,
            "engine_build_s": setup_s, "three_way": three, "slot_update_ms": copy_ms}


def wave_serve_phase(torch, cfg, params) -> dict:
    """The wave ServeEngine: two length buckets of four requests."""
    import numpy as np

    import repro_torch
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   continuous=False, device="cuda")
    if not isinstance(eng, ServeEngine):
        fail(f"wave: serve_engine(continuous=False) gave {type(eng).__name__}")
    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    new_tokens = 16
    reset_launch_counts()
    t_serve = time.perf_counter()
    for i, n in enumerate((200,) * 4 + (333,) * 4):
        eng.submit(Request(i, rng.integers(1, V, n).astype(np.int32), max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = launch_counts()
    check_streams(done, 8, new_tokens, V, "wave")
    st = eng.stats()
    need_b2 = cfg.n_layers * st["n_decode_steps"]
    if launches["decode_attention.shared"] < need_b2:
        fail(f"wave: B2 (shared form) launched {launches['decode_attention.shared']} times, "
             f"< {need_b2} ({cfg.n_layers} layers x {st['n_decode_steps']} decode steps)")
    if launches["flash_attention"] < cfg.n_layers * st["n_waves"]:
        fail(f"wave: B3 launched {launches['flash_attention']} times, < "
             f"{cfg.n_layers} layers x {st['n_waves']} waves")
    n_tok = sum(len(r.output) for r in done)
    p50 = statistics.median(eng.decode_step_s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"wave: {len(done)} requests in {st['n_waves']} waves, {n_tok} tokens in {wall:.2f}s = "
        f"{n_tok / wall:.1f} tok/s; decode step p50 {1e3 * p50:.1f} ms over "
        f"{st['n_decode_steps']} steps; launches {json.dumps(launches)}; "
        f"peak device memory {peak_gb:.2f} GB")
    return {"launches": launches, "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "decode_p50_ms": 1e3 * p50, "stats": st, "peak_mem_gb": peak_gb}


# -- phase 8: serve the MoE arch -------------------------------------------------

def build_moe_model(torch):
    """granite-moe-1b-a400m at its published size, random weights from seed
    0 (the router f32, everything else bf16)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    log(f"moe: granite-moe-1b-a400m {cfg.n_layers}x{cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.resolved_head_dim} experts "
        f"{cfg.n_experts} top-{cfg.top_k} ff {cfg.d_ff} vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f}B params in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def moe_prompts(cfg) -> list:
    """4 x 200 and 4 x 333 prompt tokens; requests 0 and 1 share their first
    128 tokens (a prefix the paged engine maps twice)."""
    import numpy as np

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (200,) * 4 + (333,) * 4]
    prompts[1][:128] = prompts[0][:128]
    return prompts


def serve_result(what: str, eng, done, n: int, new_tokens: int, vocab: int, wall: float,
                 launches: dict, setup_s: float) -> dict:
    """Check one engine's served requests and log and return its numbers."""
    check_streams(done, n, new_tokens, vocab, what)
    st = eng.stats()
    n_tok = sum(len(r.output) for r in done)
    p50 = statistics.median(eng.decode_step_s)
    log(f"{what}: {len(done)} requests, {n_tok} tokens in {wall:.2f}s = "
        f"{n_tok / wall:.1f} tok/s; decode step p50 {1e3 * p50:.1f} ms over "
        f"{st['n_decode_steps']} steps; set-up {setup_s:.1f}s; launches "
        f"{json.dumps(launches)}; {json.dumps(st)}")
    log(f"{what}: first tokens {[r.output[:4] for r in done]}")
    return {"launches": launches, "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "decode_p50_ms": 1e3 * p50, "decode_step_ms": [1e3 * x for x in eng.decode_step_s],
            "n_decode_steps": st["n_decode_steps"], "stats": st, "engine_build_s": setup_s,
            "first_tokens": [r.output[:4] for r in done]}


def moe_launch_check(what: str, cfg, launches: dict, graph_runs: int) -> None:
    """Every decode step, prefill, chunk or wave ran all of the MoE layers:
    three B5 launches per layer per run, and no others."""
    want = 3 * cfg.n_layers * graph_runs
    if launches["moe_gmm"] != want:
        fail(f"moe {what}: B5 launched {launches['moe_gmm']} times, not {want} "
             f"(3 x {cfg.n_layers} layers x {graph_runs} model calls)")


def moe_serve_phase(torch, cfg, params) -> dict:
    """granite-moe-1b-a400m through the paged, slot and wave engines, the
    same 8 greedy requests (16 new tokens each) in each; each engine's
    kernel launch counts set to 0 just before it serves and read just
    after."""
    import numpy as np

    import repro_torch
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, PagedEngine, Request, ServeConfig

    prompts = moe_prompts(cfg)
    new_tokens = 16
    out: dict[str, dict] = {}

    # paged: request 0 prefills first, so request 1 maps its prefix pages
    rt = Runtime(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   paged=PagedConfig(page_size=16, prefill_chunk=128),
                                   device="cuda", runtime=rt)
    if not isinstance(eng, PagedEngine):
        fail(f"moe paged: serve_engine gave {type(eng).__name__}")
    setup_s = time.perf_counter() - t0
    log(f"moe paged: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
        f"n_executors={eng.n_executors} decode nodes={len(eng._decode_exe.graph)} "
        f"chunk nodes={len(eng._chunk_exe.graph)}")
    reset_launch_counts()
    t_serve = time.perf_counter()
    eng.submit(Request(0, prompts[0], max_new_tokens=new_tokens))
    while eng.prefills or eng.pending:
        eng.step()
    for i in range(1, len(prompts)):
        eng.submit(Request(i, prompts[i], max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = launch_counts()
    st = eng.stats()
    moe_launch_check("paged", cfg, launches, st["n_decode_steps"] + st["n_chunks"])
    if st["n_shared_pages"] < 8:
        fail(f"moe paged: the 128-token prefix was not shared ({st})")
    if launches["paged_decode_attention"] != cfg.n_layers * st["n_decode_steps"]:
        fail(f"moe paged: B1 launched {launches['paged_decode_attention']} times")
    res = serve_result("moe paged", eng, done, len(prompts), new_tokens, cfg.vocab_size, wall,
                       launches, setup_s)
    three, inputs = three_way_decode(torch, eng, np.random.default_rng(5), "moe paged")
    res.update({"three_way": three, "trace": profile_decode(torch, eng, inputs, "moe paged"),
                "setup_s": eng.setup_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    out["paged"] = res
    rt.close()
    del eng

    # slot: 4 requests, one step, 4 more, so admissions overlap decode steps
    eng, rt, res = serve_slot(torch, cfg, params, prompts, new_tokens, "moe slot")
    launches, st = res["launches"], res["stats"]
    moe_launch_check("slot", cfg, launches, st["n_decode_steps"] + len(prompts))
    if launches["decode_attention.per_row"] != cfg.n_layers * st["n_decode_steps"]:
        fail(f"moe slot: B2 launched {launches['decode_attention.per_row']} times")
    if launches["flash_attention"] != cfg.n_layers * len(prompts):
        fail(f"moe slot: B3 launched {launches['flash_attention']} times")
    check_slot_decode(torch, eng, rt, res, "moe slot")
    out["slot"] = res
    del eng

    # wave: two waves of four equal-length prompts, the model run eagerly
    res = serve_wave(torch, cfg, params, prompts, new_tokens, "moe wave")
    launches, st = res["launches"], res["stats"]
    moe_launch_check("wave", cfg, launches, st["n_decode_steps"] + st["n_waves"])
    if launches["decode_attention.shared"] != cfg.n_layers * st["n_decode_steps"]:
        fail(f"moe wave: B2 launched {launches['decode_attention.shared']} times")
    if launches["flash_attention"] != cfg.n_layers * st["n_waves"]:
        fail(f"moe wave: B3 launched {launches['flash_attention']} times")
    out["wave"] = res
    return out


def serve_slot(torch, cfg, params, prompts, new_tokens: int, what: str):
    """The per-slot ContinuousEngine over ``prompts``: the prefill graphs of
    their lengths (exact lengths: MoE and recurrent archs) captured up
    front, then 4 requests, one step and the rest, so admissions overlap
    decode steps; the launch counts set to 0 just before serving and read
    just after.  Returns (engine, its runtime, result)."""
    import repro_torch
    from repro_torch.runtime import Runtime
    from repro_torch.serve import ContinuousEngine, Request, ServeConfig

    lens = sorted({len(p) for p in prompts})
    rt = Runtime(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   device="cuda", runtime=rt)
    if not isinstance(eng, ContinuousEngine):
        fail(f"{what}: serve_engine gave {type(eng).__name__}")
    t1 = time.perf_counter()
    eng.warmup(lens)
    eng.setup_s["prefill_capture"] = time.perf_counter() - t1
    setup_s = time.perf_counter() - t0
    if sorted(eng._prefill_exes) != lens:
        fail(f"{what}: prefill graphs {sorted(eng._prefill_exes)}, not exact lengths {lens}")
    kinds: dict[str, int] = {}
    for nd in eng._decode_exe.graph.nodes:
        kinds[nd.kind] = kinds.get(nd.kind, 0) + 1
    prefill_nodes = {n: len(e.graph) for n, e in eng._prefill_exes.items()}
    log(f"{what}: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
        f"n_executors={eng.n_executors} decode nodes={len(eng._decode_exe.graph)} "
        f"{json.dumps(kinds)}; prefill graph nodes {json.dumps(prefill_nodes)}")
    reset_launch_counts()
    t_serve = time.perf_counter()
    for i in range(4):
        eng.submit(Request(i, prompts[i], max_new_tokens=new_tokens))
    eng.step()
    for i in range(4, len(prompts)):
        eng.submit(Request(i, prompts[i], max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    res = serve_result(what, eng, done, len(prompts), new_tokens, cfg.vocab_size, wall,
                       launch_counts(), setup_s)
    if res["stats"]["n_overlapped_prefills"] < 1:
        fail(f"{what}: no admission overlapped a decode step ({res['stats']})")
    res.update({"setup_s": eng.setup_s, "decode_nodes": len(eng._decode_exe.graph),
                "decode_kinds": kinds, "prefill_nodes": prefill_nodes})
    return eng, rt, res


def check_slot_decode(torch, eng, rt, res: dict, what: str) -> None:
    """The slot engine's decode step run three ways on a random cache, a
    profile of a few steps, the peak memory; then its runtime closes."""
    three, inputs = three_way(torch, eng._decode_exe, eng.n_executors,
                              slot_decode_args(torch, eng), what,
                              (eng.capacity, eng.cfg.padded_vocab))
    res.update({"three_way": three, "trace": profile_decode(torch, eng, inputs, what),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    log(f"{what}: peak device memory {res['peak_mem_gb']:.2f} GB")
    rt.close()


def serve_wave(torch, cfg, params, prompts, new_tokens: int, what: str) -> dict:
    """The wave ServeEngine over ``prompts`` (two waves of four equal
    lengths, the model run eagerly), the launch counts set to 0 just before
    serving and read just after."""
    import repro_torch
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   continuous=False, device="cuda")
    if not isinstance(eng, ServeEngine):
        fail(f"{what}: serve_engine(continuous=False) gave {type(eng).__name__}")
    setup_s = time.perf_counter() - t0
    reset_launch_counts()
    t_serve = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=new_tokens))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    res = serve_result(what, eng, done, len(prompts), new_tokens, cfg.vocab_size, wall,
                       launch_counts(), setup_s)
    if res["stats"]["n_waves"] != 2:
        fail(f"{what}: {res['stats']['n_waves']} waves, not 2")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{what}: peak device memory {res['peak_mem_gb']:.2f} GB")
    return res


# -- phase 9: serve the recurrent archs -------------------------------------------

RECURRENT = (("falcon-mamba-7b", "mamba"), ("recurrentgemma-2b", "griffin"))


def build_recurrent_model(torch, arch: str, tag: str):
    """``arch`` at its published size, random weights from seed 0 (the f32
    leaves — Mamba's A_log, D, dt_bias, RG-LRU's lam — f32, everything
    else bf16)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    kinds = {k: cfg.layer_kinds().count(k) for k in sorted(set(cfg.layer_kinds()))}
    log(f"{tag}: {arch} {cfg.n_layers}x{cfg.d_model} kinds {json.dumps(kinds)} d_inner "
        f"{cfg.d_inner} state {cfg.ssm_state} rnn {cfg.rnn_width} vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f}B params in {time.perf_counter() - t0:.1f}s")
    return cfg, params, n_params


def recurrent_launch_check(what: str, cfg, launches: dict, calls: int, decode_steps: int,
                           form: str) -> None:
    """Every model call (prefill or decode step) ran every layer once: B6
    per Mamba layer, B7 per RG-LRU layer, B3 per attention layer in a
    prefill and B2 (``form``) per attention layer in a decode step, and no
    other launches of them."""
    kinds = cfg.layer_kinds()
    prefills = calls - decode_steps
    want = {"ssm_scan": kinds.count("ssm") * calls, "rglru_scan": kinds.count("rglru") * calls,
            "flash_attention": kinds.count("attn") * prefills,
            f"decode_attention.{form}": kinds.count("attn") * decode_steps}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{what}: {name} launched {launches[name]} times, not {n} ({calls} model "
                 f"calls, {decode_steps} of them decode steps, kinds {sorted(set(kinds))})")


def recurrent_serve_phase(torch, arch: str, tag: str) -> dict:
    """One recurrent arch at full width through the slot and wave engines,
    the same 8 greedy requests (16 new tokens each) in each; each engine's
    launch counts set to 0 just before it serves and read just after.  The
    paged engine must refuse the arch."""
    import repro_torch
    from repro_torch.serve import PagedConfig, ServeConfig

    cfg, params, n_params = build_recurrent_model(torch, arch, tag)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    prompts = moe_prompts(cfg)
    new_tokens = 16
    out: dict = {"n_params": n_params, "weights_gb": weights_gb}
    log(f"{tag}: weights take {weights_gb:.2f} GB on the card")

    try:
        repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                 paged=PagedConfig(page_size=16, prefill_chunk=128),
                                 device="cuda")
        fail(f"{tag}: the paged engine accepted {arch}")
    except ValueError as e:
        if "paged serving requires" not in str(e):
            raise
        log(f"{tag} paged: refused as in the reference: {e}")
    out["paged_refused"] = True

    eng, rt, res = serve_slot(torch, cfg, params, prompts, new_tokens, f"{tag} slot")
    st = res["stats"]
    recurrent_launch_check(f"{tag} slot", cfg, res["launches"],
                           st["n_decode_steps"] + len(prompts), st["n_decode_steps"], "per_row")
    check_slot_decode(torch, eng, rt, res, f"{tag} slot")
    out["slot"] = res
    del eng

    res = serve_wave(torch, cfg, params, prompts, new_tokens, f"{tag} wave")
    st = res["stats"]
    recurrent_launch_check(f"{tag} wave", cfg, res["launches"],
                           st["n_decode_steps"] + st["n_waves"], st["n_decode_steps"], "shared")
    out["wave"] = res
    del params
    torch.cuda.empty_cache()
    return out


def three_way(torch, exe, n_executors: int, args: tuple, what: str,
              shape: tuple) -> tuple[dict, dict]:
    """One run of a captured graph as a static plan, under the dynamic
    scheduler and through sequential ``Graph.execute``: its first output (a
    decode step's logits, an LSTM's hidden states) must have ``shape``, be
    finite, and be identical bit for bit across the three."""
    inputs = exe.captured.bind(args)

    def first(outputs):
        out = exe.captured.unflatten(outputs)
        return out[0] if isinstance(out, tuple) else out

    out, t = {}, {}
    for mode in ("static", "dynamic"):
        t0 = time.perf_counter()
        res = exe.execute_host(inputs, n_executors=n_executors, host_mode=mode)
        out[mode] = first(res.outputs)
        torch.cuda.synchronize()
        t[mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sequential"] = first(exe.graph.execute(inputs))
    torch.cuda.synchronize()
    t["sequential"] = time.perf_counter() - t0
    ref = out["sequential"]
    if tuple(ref.shape) != tuple(shape) or not torch.isfinite(ref).all():
        fail(f"{what} three-way: output {tuple(ref.shape)} not finite {tuple(shape)}")
    for mode in ("static", "dynamic"):
        if not torch.equal(out[mode], ref):
            diff = (out[mode] - ref).abs().max().item()
            fail(f"{what} three-way: {mode} output differs from sequential (max {diff})")
    log(f"{what}: three-way: static, dynamic and sequential outputs identical; host s "
        + json.dumps({k: round(v, 4) for k, v in t.items()}))
    return {"identical": True, "host_s": t}, inputs


def three_way_decode(torch, eng, rng, what: str = "paged") -> tuple[dict, dict]:
    """The paged engine's decode step over the pools the run left behind,
    with tables for contexts up to 1000 tokens."""
    import numpy as np

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
    return three_way(torch, eng._decode_exe, eng.n_executors, args, what,
                     (B, eng.cfg.padded_vocab))


def slot_decode_args(torch, eng) -> tuple:
    """A per-slot cache with random K/V (or random recurrent state) and rows
    at depths up to 1000 (one idle), and random tokens: the slot engine's
    decode-step inputs."""
    from repro_torch.models import transformer

    cache = transformer.init_cache(eng.cfg, eng.capacity, eng.scfg.max_len, per_slot=True,
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = [1000, 17, 300, 640, 64, 129, 2, 0]
    for lc in cache["layers"]:
        for kk in ("k", "v", "h", "conv"):
            if kk in lc:
                lc[kk] = torch.randn(lc[kk].shape, generator=gen,
                                     device="cuda").to(lc[kk].dtype)
        if "pos" in lc:            # a ring of C entries: each row's last C positions
            C = lc["pos"].shape[1]
            for b, n in enumerate(lens):
                p = torch.arange(max(0, n - C), n, dtype=torch.int32, device="cuda")
                lc["pos"][b, (p % C).long()] = p
    cache["len"] = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tokens = torch.randint(1, eng.cfg.vocab_size, (eng.capacity, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    return eng.params, cache, tokens


def profile_decode(torch, eng, inputs, what: str, steps: int = 3) -> dict:
    """Where one decode step's time goes (:func:`profile_static` of the
    engine's decode graph)."""
    return profile_static(torch, eng._decode_exe, eng.n_executors, inputs, what, steps,
                          "decode step")


def profile_static(torch, exe, n_executors: int, inputs, what: str, steps: int,
                   unit: str) -> dict:
    """:func:`profile_calls` over ``steps`` static-plan runs of ``exe``."""
    return profile_calls(
        torch, lambda: exe.execute_host(inputs, n_executors=n_executors, host_mode="static"),
        what, steps, unit)


def profile_calls(torch, fn, what: str, steps: int, unit: str) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``fn``.
    Device busy time is the union of the CUDA kernel intervals (streams may
    overlap); its share of the host wall time is what the card was busy.
    Reports "not measured" if the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if not spans:
        log(f"{what} profile: no device events recorded (device busy share not measured)")
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
           "top": [(name[:80], ms / steps / 1e3) for name, ms in top],
           "by_kernel": {name[:120]: ms / steps / 1e3 for name, ms in by_kernel.items()}}
    log(f"{what} profile: {unit} wall {out['wall_ms_per_step']:.2f} ms, device busy "
        f"{out['device_busy_ms_per_step']:.2f} ms ({100 * out['busy_share']:.1f}%), "
        f"{out['n_kernels']} kernels/step")
    for name, ms in out["top"]:
        log(f"{what} profile:   {ms:8.3f} ms/step  {name}")
    return out


def _parse() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=18,
                    help="gemma-2b depth for the serve phases (full: 18)")
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
    build_s = time.perf_counter() - t0
    log(f"build: {len(built)} kernel(s) in {build_s:.1f}s into {_build.build_dir()}")
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"build: {name}: {' | '.join(ptxas[:6])}")

    phase_s: dict[str, float] = {"build": build_s}

    def timed(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t1
        return out

    # phase 3: kernels against their plain versions
    kern = timed("kernels", kernel_phase, torch)
    # phase 4: small inputs against the CPU reference
    timed("small", small_phase, torch)
    small_train = timed("small_train", small_train_phase, torch)
    # phase 5: the paper's Table-1 "large" LSTM through eager and runtime
    # paths, and its gradient
    lstm = timed("lstm", lstm_phase, torch)
    # phase 6: train full-width gemma-2b, then granite-moe-1b-a400m,
    # recurrentgemma-2b and falcon-mamba-7b (its depth cut), each freed
    # before the next is built and before the serve phases
    train = timed("train", train_phase, torch)
    family_train = {tag: timed(tag, family_train_phase, torch, arch, tag, layers)
                    for arch, tag, layers in FAMILY_TRAIN}
    # phase 7: serve full-width gemma-2b through the three engines
    t1 = time.perf_counter()
    cfg, params = build_model(torch, args.layers)
    serve = {"paged": paged_serve_phase(torch, cfg, params),
             "slot": slot_serve_phase(torch, cfg, params),
             "wave": wave_serve_phase(torch, cfg, params)}
    phase_s["serve"] = time.perf_counter() - t1
    # phase 8: serve full-width granite-moe-1b-a400m through the three engines
    del params
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    moe_cfg, moe_params = build_moe_model(torch)
    moe = moe_serve_phase(torch, moe_cfg, moe_params)
    phase_s["moe_serve"] = time.perf_counter() - t1
    # phase 9: serve full-width falcon-mamba-7b and recurrentgemma-2b through
    # the slot and wave engines (each model freed before the next is built)
    del moe_params
    torch.cuda.empty_cache()
    recurrent = {tag: timed(f"{tag}_serve", recurrent_serve_phase, torch, arch, tag)
                 for arch, tag in RECURRENT}
    log("phases: " + " ".join(f"{k}={v:.1f}s" for k, v in phase_s.items()))

    # each kernel: its main-path launches (summed over the paths that run
    # it), its worst error over every case, and the times of its main case
    spec = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:193", "window=None",
            ("paged", "moe_paged")),
        "decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/dense_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:82", "per_row,window=None",
            ("slot", "wave", "moe_slot", "moe_wave", "griffin_slot", "griffin_wave")),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:96", "S=512,window=None",
            ("slot", "wave", "moe_slot", "moe_wave", "griffin_slot", "griffin_wave",
             "train", "moe_train", "griffin_train")),
        # the backward kernels replace XLA's autodiff of the JAX functions
        # (the JAX package has no backward kernel, no pallas_call); B3's in
        # its two forms, each with its own main path
        "flash_attention_bwd.mma": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            "src/repro/models/layers.py:103", "B=4,S=512,window=None,bfloat16",
            ("train", "moe_train", "griffin_train")),
        "flash_attention_bwd.simt": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            "src/repro/models/layers.py:103", "smoke,B=2,S=32,float32",
            ("small_train_gemma", "small_train_moe", "small_train_griffin")),
        "lstm_cell": (
            "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu",
            "src/repro/kernels/lstm_cell/kernel.py:34", "N=64,H=1024,float32/float32",
            ("lstm", "lstm_grad")),
        "lstm_cell_bwd": (
            "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu",
            "src/repro/core/wavefront.py:94", "N=64,H=1024,float32/float32", ("lstm_grad",)),
        "moe_gmm": (
            "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm/kernel.py:41", "E=32,C=8,D=1024,F=512,bfloat16",
            ("moe_paged", "moe_slot", "moe_wave", "moe_train")),
        "ssm_scan": (
            "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan/kernel.py:54", "prefill,B=1,S=333,D=8192,St=16",
            ("mamba_slot", "mamba_wave")),
        # B6's training form (the same kernel keeping a checkpoint every 32
        # steps for B6-bwd), on the training paths
        "ssm_scan_train": (
            "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan/kernel.py:54", "train,B=4,S=512,D=8192,St=16",
            ("mamba_train", "small_train_mamba")),
        "rglru_scan": (
            "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru_scan/kernel.py:48", "prefill,B=1,S=333,R=2560",
            ("griffin_slot", "griffin_wave", "griffin_train")),
        # the backwards of B5 / B6 / B7 (the JAX package differentiates their
        # functions with XLA): "replaces" names the forward they differentiate
        "moe_gmm_bwd": (
            "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
            "src/repro/kernels/moe_gmm/kernel.py:41", "train,E=32,C=640,D=1024,F=512,bfloat16",
            ("moe_train", "small_train_moe")),
        "ssm_scan_bwd": (
            "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan/kernel.py:54", "train,B=4,S=512,D=8192,St=16",
            ("mamba_train", "small_train_mamba")),
        "rglru_scan_bwd": (
            "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru_scan/kernel.py:48", "train,B=4,S=512,R=2560",
            ("griffin_train", "small_train_griffin")),
    }
    runs = {**{p: r["launches"] for p, r in serve.items()},
            **{f"moe_{p}": r["launches"] for p, r in moe.items()},
            **{f"{tag}_{p}": recurrent[tag][p]["launches"] for _, tag in RECURRENT
               for p in ("slot", "wave")},
            "lstm": {"lstm_cell": sum(lstm["launches"].values())},
            "lstm_grad": {k: sum(p[k] for p in lstm["grad"]["launches"].values())
                          for k in ("lstm_cell", "lstm_cell_bwd")},
            "train": train["launches"],
            **{tag: r["launches"] for tag, r in family_train.items()},
            **{f"small_train_{tag}": r["launches"] for tag, r in small_train.items()}}
    kernels = []
    for name, (source, replaces, main_case, paths) in spec.items():
        kind, _, form = name.partition(".")      # a form's rows: the cases it takes
        rows = {c: r for c, r in kern[kind].items() if not form or r.get("form") == form}
        row = rows[main_case]
        launches = sum(runs[p].get(name, 0) for p in paths)
        if launches <= 0:
            fail(f"{name} was never launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
        if "_bwd" in name:
            kernels[-1]["note"] = "backward of a ported kernel; no pallas_call in the JAX package"
        # B3 forward + backward beside SDPA's; B5-bwd's halves beside a
        # torch.bmm each; why a scan's backward has no library call
        for key in ("fwd_bwd_ms", "dx_ms", "dw_ms", "library_dx_ms", "library_dw_ms",
                    "serving_ms", "library_note"):
            if key in row:
                kernels[-1][key] = row[key]
    if not (serve["slot"]["launches"]["decode_attention.per_row"] > 0
            and serve["wave"]["launches"]["decode_attention.shared"] > 0):
        fail("B2 was not launched in both its forms")
    # the full-width bf16 serve and train paths: every B3 and B5 launch on
    # the tensor cores (the small f32 train steps: all SIMT, checked there)
    for path, counts in runs.items():
        if not path.startswith("small_train"):
            check_kernel_forms(path, counts, "mma",
                               [k for k in ("flash_attention", "moe_gmm") if counts.get(k)])
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": kernels, "kernel_rows": kern, "lstm": lstm,
             "small_train": small_train, "train": train, "family_train": family_train,
             "serve": serve,
             "moe_serve": moe, "recurrent_serve": recurrent, "build_s": build_s,
             "event_timed_calls": len(EVENT_TIMED), "scaled_timings": len(SCALED),
             "ptxas": {name: [ln.strip() for ln in b["log"].splitlines()
                              if "entry function" in ln or "registers" in ln or "spill" in ln]
                       for name, b in built.items()},
             "phase_s": phase_s, "total_s": time.perf_counter() - t_all},
            indent=1,
            default=str))
    log(f"timer: {len(EVENT_TIMED)} device times taken with CUDA events, the rest with "
        f"torch.profiler ({len(SCALED)} scaled for records it dropped in every window)")
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
