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
   attention shape (Hq=16, Hkv=8, hd=64), B1 / B2 / B3 at
   h2o-danube3-4b's (32 / 8 heads of 120: B3 padded to 128 on the tensor
   cores; B1 and B3 with and without a 256-token window, which binds at
   B1's depths), B3 at olmoe's (16 heads of 128), on a 2048-token gemma
   prompt (its 64-row tile form), on a ragged f32 prompt at h2o's width and
   at hd 60 in bf16 (both on the CUDA cores, the form each call takes
   checked); B3 at whisper-medium's non-causal shapes (16 / 16 heads of 64,
   B=4: the encoder's 1500 x 1500, cross-attention of 32 prompt rows and of
   one decode row against 1500) and llava-next-34b's ragged causal prefill
   (B=2, S=2880+64, 56 / 8 heads of 128), B2 at their decode heads (G = 1,
   hd 64; G = 7, hd 128) in the shared and per-row forms, each in bf16
   (timed, beside SDPA) and f32; every row compared, idle rows
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
   + backward), also at granite-moe-1b-a400m's (16 / 8 heads of 64),
   recurrentgemma-2b's (10 / 1 heads of 256) and h2o-danube3-4b's (B=4,
   S=512, 32 / 8 heads of 120) training widths, ragged in f32 at h2o's
   width and at hd 60 in bf16 (CUDA cores), B4's at
   N=64, H=1024 (f32; bf16 gates; yardstick
   ``aten._thnn_fused_lstm_cell_backward_impl``); the backwards of B5, B6
   and B7 at their training paths' shapes (B5-bwd at granite's E=32,
   C=640, D x F = 1024 x 512 and 512 x 1024, bf16 on the tensor cores,
   beside ``torch.bmm`` for dX and for dW; B6-bwd at falcon-mamba's B=4,
   S=512, D=8192, St=16 with c in bf16; B7-bwd at recurrentgemma's B=4,
   S=512, R=2560), at the small train phase's f32 smoke shapes and at
   ragged ones, B6's da / db / dh0 and all of B7's bit-equal to their
   plain versions; B3's backward at the frontend archs' training shapes
   (whisper-medium, B=4: its encoder's 1500 x 1500 and its cross-attention's
   448 x 1500, non-causal, and its decoder's 448 causal, 16 / 16 heads of
   64; llava-next-34b's 56 / 8 heads of 128, causal, B=4 at S=512 and B=2
   at its served 2944), bf16, held to the plain version run in f32 on the
   same bf16 inputs: the training forward within BF16_ULPS bf16 ulps of
   each output row's largest value and its log-sum-exp within 2e-5, the
   backward within BF16_BWD_ULPS, beside SDPA forward + backward;
   every gradient element compared, the same bits on two calls; the
   multi-tensor AdamW kernels (the clip norm and the update) against the
   per-leaf loop on h2o-danube3-4b's leaves at full width (one layer) and
   granite-moe-1b-a400m's (two layers, f32 routers): from the same p, m, v
   and gradients, given the loop's clip scale, p, m and v bit for bit, the
   norm within 1e-6 and the same bits twice; timed on all of h2o's 3.96 B
   parameters beside the loop and beside ``torch._fused_adamw_`` after a
   ``torch._foreach_norm`` clip (moments in the parameters' dtype: the
   library holds no f32 moments for bf16 parameters);
4. small   — the smoke gemma-2b, granite-moe-1b-a400m, yi-9b,
   h2o-danube3-4b (and an h2o smoke at its real head dim 120: d_model 240,
   2 / 1 heads), command-r-plus-104b (parallel blocks), falcon-mamba-7b and
   recurrentgemma-2b configs in f32 (and, in the train part, whisper-medium
   and llava-next-34b with their frames or image rows): one captured paged decode step (the
   attention archs), one captured per-slot prefill and one captured
   per-slot decode step each on the card against the eager steps on the
   CPU, every row compared (recurrentgemma's prompt is longer than its
   16-token window, so the ring cache wraps), every B3 / B5 launch on the
   SIMT form; and a small
   LSTM (L=2, T=5, B=4, H=64) captured and run on the card, sequential and
   stacked, against the eager CPU run; then each of those smoke configs'
   loss
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
   layers), falcon-mamba-7b at FALCON_TRAIN_LAYERS of its 64 layers and
   h2o-danube3-4b (3.96 B parameters, B3 and B3-bwd at hd 120), 3 AdamW
   steps each at B=4, S=512 with remat: losses, MoE aux and
   gradient norms finite, the MoE loss = ce + 0.01 aux, per step exactly
   2 forward launches and 1 backward a layer of B3, B5 (three products a
   layer), B6 and B7 and none of any other kernel, B3 / B5 all on the
   tensor cores; ms/step p50, tokens/s, peak memory and a profiled step;
   then the frontend archs the same way, each batch the bigram stream's
   tokens with ``make_batch``'s embeddings: whisper-medium whole (24
   encoder + 24 decoder layers, B=4, 448 text tokens, frames [4, 1500,
   1024]: B3's training forward 24 + 2 x 48 and its backward 24 + 48 a
   step, the encoder's not recomputed) and llava-next-34b at full width
   cut to LLAVA_TRAIN_LAYERS of its 60 layers (B=4, 256 image rows + 256
   text tokens), B3 also counted by kind (self, encoder, cross);
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
   512-token prefill); the paged and slot engines' captured graphs are
   verified as the serving CLI's ``--check`` does (``check_engine``: no
   error finding, the paged pair certified: no H-XWW, every pool leaf
   written by decode, the chunk graph read-only over them), with the
   seconds it adds to set-up, and two planted chunk graphs that write a
   pool (an ``index_put``, and ``k[0] = k[1]`` through a view), captured
   on the card, must be caught (H-XWW) and refused under ``strict``;
   hwperf — the card host's topology and whether its OS pins a thread;
   the interference matrix on the card (gemm, elementwise and memory
   classes sized like gemma-2b's decode kernels, each a kernel loop on its
   own stream fed by its own pinned host thread; 3 solo and 6 pair runs a
   repeat), measured four times in turns: twice with each window one CUDA
   graph launch (the card's contention alone), twice launched eagerly
   (the host's feed included), with each entry's spread; a fresh
   ``Runtime(pinning="on")`` adopts the graph runs' mean matrix as its
   contention model (every executor thread on its planned cores, or the
   OS's refusal reported with one warning and the pool unpinned);
   gemma-2b's decode step under ``cpf-contention`` and CPF, 8 greedy steps
   from one prefill, the same tokens; then the serving CLI once, ``--arch
   gemma-2b --paged --check strict --pinning on`` at full width;
   fleet — ``repro_torch.fleet`` with this process's model freed: two
   replicas, each a spawned process holding full-width gemma-2b (bf16,
   seed 0, an untied output head, so that a stream depends on its whole
   context) in a ``ContinuousEngine`` of 4 slots, one calibration store;
   run A serves 8 requests (4 x 200 and 4 x 333 tokens, 16 new), run B
   the same with a SIGKILL after 24 tokens (every request whole, one
   failover and respawn, the seconds from the fail event to the first
   replayed token, every stream not failed over equal to run A's bit for
   bit, the replayed ones counted), then 4 of run A's prompts with at
   least one on the respawned replica, equal to run A's; the card's free
   memory falls by both replicas' weights and comes back within 1 GiB
   after close; each boot's seconds and set-up (the respawn's calibration
   from the store); the serving CLI with ``--smoke --replicas 2``,
   ``--paged`` and ``--continuous`` at once, started after run B.  The
   replicas launch B1 / B2 / B3, in processes whose counts the ``kernels``
   line does not see;
8. moe     — full-width granite-moe-1b-a400m (24 layers, 32 experts top-8,
   random weights from seed 0; gemma's freed first) through the same three
   engines, 8 greedy requests of 4 x 200 and 4 x 333 prompt tokens and 16
   new tokens, two sharing a 128-token prefix; slot admissions 4 + 4.
   Every model call launches B5 three times per layer, and the count is
   checked exactly; the paged and slot engines run the three-way decode
   check and profile a few decode steps;
9. recurrent — falcon-mamba-7b at full width, cut to FALCON_SERVE_LAYERS
   of its 64 Mamba layers, then full-width recurrentgemma-2b (26 layers: 18
   RG-LRU, 8 local attention), random weights from seed 0, the previous
   model freed
   first, each through the slot and wave engines: 8 greedy requests of 4 x
   200 and 4 x 333 prompt tokens, 16 new tokens each, slot admissions 4 +
   4.  Every model call launches B6 once per Mamba layer and B7 once per
   RG-LRU layer (B2 / B3 once per attention layer), checked exactly; the
   slot engine runs the three-way decode check and profiles a few decode
   steps; ``serve_engine(..., paged=PagedConfig(...))`` must refuse both;
10. zoo    — yi-9b at full width cut to ZOO_YI_LAYERS of its 48 layers
   (slot engine), h2o-danube3-4b at full width cut to ZOO_H2O_LAYERS of
   its 24 (32 / 8 heads of 120, window 4096; slot and paged engines: B1, B2
   and B3 at hd 120) and command-r-plus-104b cut to 8 of its 64 layers at
   full width (parallel attention + FFN blocks; slot and paged engines),
   random weights from seed 0, each freed before the
   next: granite's 8 requests (two sharing a 128-token prefix), slot
   admissions 4 + 4, B3 once a layer a prefill and B2 / B1 once a layer a
   decode step, exact; each engine's three-way decode check and profile;
   for command-r, on how many layers the static decode plan put the
   attention and FFN products on different streams;
11. frontend — whisper-medium whole (24 encoder + 24 decoder layers) and
   llava-next-34b at full width cut to LLAVA_SERVE_LAYERS of its 60
   layers, random weights from seed 0, each freed before the next, through
   ``serve.step``'s prefill and decode steps with their embeddings (4 x 32
   tokens and frames [4, 1500, 1024] from ``make_batch``, 16 new tokens;
   2 x (2880 image rows + 64 tokens), 8 new), eagerly and captured by
   ``repro_torch.compile`` on a ``Runtime``: greedy tokens equal, launch
   counts exact (B3 split into encoder, self and cross by its shapes; B2),
   the decode step three ways and profiled; the slot and paged engines
   refuse both, the wave engine refuses whisper and serves llava as text;
12. dist   — the distribution layer (``repro_torch.dist``): (d) B2's
   log-sum-exp form against its plain version at gemma-2b's decode_32k
   rank share (4 rows, 4096 cache entries; shared and per row, an idle
   row; bf16 timed beside SDPA, and f32); (a) a real NCCL group of world 1
   and a 1x1 mesh: DIST_STEPS full-width gemma-2b steps through the
   sharded path (DTensor state placed by ``state_pspecs``) at B=4, S=512
   on the train phase's state and batches, losses and gradient norms held
   to the train phase's unsharded steps, B3 launches per step as there;
   (c) the ``"mesh"`` backend on the paper's LSTM recurrence graph (4 x 16
   cells on the card, B4 a cell) against the host backend, every cell bit
   for bit; (b) rank 0's share of the single-pod mesh (32 x 8) under the
   ``fake`` process group at full width (DIST_CELLS: gemma-2b and
   olmoe-1b-7b train_4k, depth cut, and gemma-2b decode_32k whole): traced
   (the cost walker's per-rank flops / bytes / collective bytes and the
   H100 roofline), then run once: measured peak under the card's memory,
   device ms, kernel launches by kind.

Every B3 and B5 launch of the full-width serve phases must take the
tensor-core form (``launches_by_path["mma"]``).  Every paged engine the
serve phases build (gemma, granite, h2o, command-r) is verified as in
phase 7, with no second build.  It prints each phase's
seconds (a ``phases:`` line), one ``{"kernels": [...]}`` JSON line, the
card line, and last ``{"ok": true, "device": {...}}``.  ``--out`` also
writes the numbers to ``DIR/chip_smoke.json``.
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
BF16_FLOPS = 989e12             # H100 SXM published dense bf16 rate
F32_FLOPS = 67e12               # H100 SXM published f32 rate outside the tensor cores
KERNEL_TOL = 3e-2               # bf16: the two paths round at other places
F32_KERNEL_TOL = 2e-5           # f32 kernels: the same math, other instruction order
BF16_ULPS = 4                   # bf16 kernel vs the f32 answer: ulps of a row's largest value
BF16_BWD_ULPS = 1               # the same for B3-bwd's frontend rows (a CPU model: 0.5;
                                # P and dS as one bf16 term each: 1.2-1.6)
SMALL_TOL = 1e-4                # f32, CPU vs card: sums in another order
LSTM_TOL = 1e-4                 # f32, stacked bmm vs per-layer mm over K=1024


def _fx_cost():
    """The port's cost walker: the kernels' work formulas, one copy for the
    bounds here and the dry-run's per-rank counts."""
    from repro_torch.analysis import fx_cost

    return fx_cost


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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.paged_decode_work(B, Hq, hd, q.element_size(), entries, kv,
                                              table.numel(), q_pos.numel())
    return fx_cost.bound_ms(flops, nbytes, BF16_FLOPS)


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


def dense_case(torch, form, *, B=8, Hq=8, Hkv=1, hd=256, C=1024, n=333 + 16, dtype=None,
               seed=1):
    """gemma-2b dense decode shapes.  per_row (the slot engine): rows at
    mixed depths and an idle row (7) that keeps no entry; shared (the wave
    engine, and the frontend archs' decode steps): a prompt ``n - 1`` tokens
    into its decode (default: 333 tokens, 16 in).  bf16 unless ``dtype``
    says otherwise.  Returns tensors on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    if form == "per_row":
        lengths = [1024, 37, 512, 700, 333, 129, 1000, 0]
        kv_pos = torch.full((B, C), -1, dtype=torch.int32)
        for b, n in enumerate(lengths):
            kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    else:
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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.dense_decode_work(B, Hq, Hkv, hd, S, k.element_size(), entries,
                                              empty_rows, kv_pos.numel(), q_pos.numel())
    return fx_cost.bound_ms(flops, nbytes, BF16_FLOPS)


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


def flash_case(torch, S, *, Hq=8, Hkv=1, hd=256, dtype=None, B=1, Skv=None, seed=2):
    """gemma-2b prefill shapes: one prompt of S tokens, model layout (bf16
    unless ``dtype`` says otherwise); ``B`` rows of S queries against
    ``Skv`` keys (cross-attention) where given."""
    dtype = dtype or torch.bfloat16
    Skv = S if Skv is None else Skv
    gen = torch.Generator(device="cuda").manual_seed(seed + S)
    q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v


def flash_keep(torch, S, window, Skv=None, causal=True, device="cuda"):
    """[S, Skv] (Skv = S unless given): key j kept for query row i, j <= i
    when causal, i - j < window when windowed."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S if Skv is None else Skv, device=device)[None, :]
    keep = j <= i if causal else torch.ones((S, j.shape[1]), dtype=torch.bool, device=device)
    if window is not None:
        keep = keep & (j > i - window)
    return keep


def flash_bound_ms(torch, q, k, window, causal=True) -> tuple[float, str]:
    """Least time for a call (causal: Sq = Skv): q, k, v read once and the
    output written once over the HBM rate, or the kept (query, key) pairs'
    flops over the card's rate for the dtype (bf16 tensor cores; f32
    outside them), whichever is larger."""
    B, S, Hq, hd = q.shape
    pairs = int(flash_keep(torch, S, window).sum()) if causal else S * k.shape[1]
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.flash_work(B, S, k.shape[1], Hq, k.shape[2], hd, q.element_size(),
                                       pairs)
    return fx_cost.bound_ms(flops, nbytes, F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS)


def check_form(name: str, wrapper, call, want: str) -> None:
    """One ``call`` of a kernel must count one launch on ``wrapper`` in
    its ``want`` form (``"mma"``: tensor cores; ``"simt"``: CUDA cores)."""
    before = dict(wrapper.launches_by_path)
    call()
    took = [f for f, n in wrapper.launches_by_path.items() if n != before[f]]
    if took != [want]:
        fail(f"{name}: the call took the {took} form(s), not {want}")


def check_kernel(torch, name, out, ref, tol=KERNEL_TOL) -> float:
    """Every element of ``out`` finite and within ``tol`` of ``ref``."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name} wrote non-finite values")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        fail(f"{name} max abs err {err} > {tol}")
    return err


def bf16_row_ulps(torch, out, exact, floor: float = 0.0) -> float:
    """The largest |out - exact| in bf16 ulps of its output row's largest
    |exact| value (the row: the last dim), that value floored at ``floor``
    times the tensor's largest."""
    top = exact.float().abs().amax(-1, keepdim=True).clamp_min(
        max(2.0 ** -126, floor * exact.float().abs().max().item()))
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((out.float() - exact.float()).abs() / ulp).max().item()


def check_near_exact(torch, name, out, exact) -> float:
    """Every element of the bf16 ``out`` finite and within ``BF16_ULPS``
    bf16 ulps of its row's largest |value| of ``exact``, the plain version
    in f32 on the same bf16 inputs (a bf16 kernel that rounds only P, to
    feed the tensor cores, and its output comes to about one); returns the
    largest absolute difference."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name} wrote non-finite values")
    ulps = bf16_row_ulps(torch, out, exact)
    err = (out.float() - exact.float()).abs().max().item()
    if not ulps <= BF16_ULPS:
        fail(f"{name} max abs err {err}: {ulps:.2f} bf16 ulps of its row's largest value, "
             f"more than {BF16_ULPS}")
    return err


# the frontend archs' attention shapes (kernel phase and frontend phase):
# whisper-medium's 16 / 16 heads of 64 (G = 1) and llava-next-34b's 56 / 8
# heads of 128 (G = 7); their decode self-attention in the shared form of
# the frontend phase's steps (whisper: B = 4, a 48-entry cache full at the
# last of 16 new tokens; llava: B = 2, 2880 image rows + 64 text + 8 new)
WHISPER_HEADS = {"Hq": 16, "Hkv": 16, "hd": 64}
LLAVA_HEADS = {"Hq": 56, "Hkv": 8, "hd": 128}
WHISPER_DECODE = {**WHISPER_HEADS, "B": 4, "C": 48, "n": 48}
LLAVA_DECODE = {**LLAVA_HEADS, "B": 2, "C": 2952, "n": 2952}
# B3's frontend calls: (B, Sq, Skv, causal, heads, tag)
FRONTEND_FLASH = ((4, 1500, 1500, False, WHISPER_HEADS, "whisper encoder"),
                  (4, 32, 1500, False, WHISPER_HEADS, "whisper cross"),
                  (4, 1, 1500, False, WHISPER_HEADS, "whisper cross decode"),
                  (2, 2944, 2944, True, LLAVA_HEADS, "llava prefill"))


# B3-bwd's frontend training calls: (B, Sq, Skv, causal, heads, tag); the
# whisper_train and llava_train phases' shapes and llava's served prefill length
FRONTEND_BWD = ((4, 1500, 1500, False, WHISPER_HEADS, "whisper encoder"),
                (4, 448, 1500, False, WHISPER_HEADS, "whisper cross"),
                (4, 448, 448, True, WHISPER_HEADS, "whisper decoder self"),
                (4, 512, 512, True, LLAVA_HEADS, "llava train"),
                (2, 2944, 2944, True, LLAVA_HEADS, "llava prefill"))


def frontend_flash_rows(torch) -> dict:
    """B3 at the frontend phase's shapes, none of which it took before:
    whisper-medium's non-causal encoder (B = 4, 1500 frames = 23 x 64 + 28,
    a ragged last key tile), the cross-attention of its 32-token prompts
    and of one decode row against the encoder's 1500 rows (16 / 16 heads of
    64, G = 1), and llava-next-34b's causal prefill of 2880 image rows + 64
    text tokens (B = 2, ragged, 56 / 8 heads of 128, G = 7).  In bf16
    (timed, beside SDPA on the same call, ``is_causal`` as the call) held
    to the plain version run in f32 on the same bf16 inputs, within
    ``BF16_ULPS`` ulps of each row's largest value (``check_near_exact``;
    the bf16 plain version's own distance to it is kept beside, as
    ``plain_err``); in f32 to the plain version within 2e-5.  The same bits
    on two calls, the form each call takes checked."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda, flash_attention_path,
                                                     flash_attention_plain)

    rows: dict[str, dict] = {}
    for B, Sq, Skv, causal, heads, tag in FRONTEND_FLASH:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = flash_case(torch, Sq, B=B, Skv=Skv, dtype=dt, **heads)
            form = flash_attention_path(dt, q.shape[-1])
            case = f"{tag},B={B},Sq={Sq},Skv={Skv},causal={causal},{str(dt)[6:]}"
            name = f"flash kernel ({case})"

            def call(q=q, k=k, v=v):
                return flash_attention_cuda(q, k, v, causal, None, 0)

            def plain(q=q, k=k, v=v):
                return flash_attention_plain(q, k, v, causal, None, 0, 1024, 512)

            out = call()
            if dt == torch.float32:
                err = check_kernel(torch, name, out, plain(), tol=F32_KERNEL_TOL)
            else:
                exact = flash_attention_plain(q.float(), k.float(), v.float(), causal, None, 0,
                                              1024, 512)
                err = check_near_exact(torch, name, out, exact)
                ulps = bf16_row_ulps(torch, out, exact)
                plain_err = (plain().float() - exact).abs().max().item()
                del exact
            if not torch.equal(call(), out):
                fail(f"{name} differs between two calls")
            check_form(name, flash_attention_cuda, call, form)
            if dt == torch.float32:
                rows[case] = {"max_abs_err": err, "form": form}
                continue
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            t = timings(torch, call, plain, sdpa(torch, qt, kt, vt, is_causal=causal), 30)
            bound_ms, bound_by = flash_bound_ms(torch, q, k, None, causal)
            rows[case] = {"max_abs_err": err, "row_ulps": ulps, "plain_err": plain_err, **t,
                          "bound_ms": bound_ms, "bound_by": bound_by, "form": form}
    return rows


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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.lstm_cell_work(N, H, gx.element_size(), b.numel(), b.element_size(),
                                           c.element_size())
    return fx_cost.bound_ms(flops, nbytes, F32_FLOPS)


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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.moe_gmm_work(E, C, D, w.shape[2], x.element_size())
    return fx_cost.bound_ms(flops, nbytes, BF16_FLOPS if x.element_size() == 2 else F32_FLOPS)


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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.scan_work((*inputs, *outputs), flops)
    return fx_cost.bound_ms(flops, nbytes, F32_FLOPS)


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
        # the plain scans loop over steps in Python: two calls time them
        t = timings(torch, lambda a=args: ssm_scan_cuda(*a), lambda a=args: ssm_scan_plain(*a),
                    None, 20, plain_iters=2)
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
                    lambda a=args: rglru_scan_plain(*a), None, 20, plain_iters=2)
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
    from repro_torch.kernels.flash_attention import (flash_attention_cuda, flash_attention_path,
                                                     flash_attention_plain)
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
    f32, bf16 = torch.float32, torch.bfloat16
    t_sec = time.perf_counter()

    def section(name):
        nonlocal t_sec
        log(f"kernels: {name} rows in {time.perf_counter() - t_sec:.1f}s")
        t_sec = time.perf_counter()

    # B1 at h2o's decode shape: rows up to 1024 deep, so a 256-token window
    # binds (its own 4096 does not at this depth)
    for shape, windows, tag in (({}, (None, 256), ""), (granite, (None,), "granite,"),
                                (h2o, (None, 256), "h2o,")):
        q, k, v, table, q_pos, live = paged_case(torch, **shape)
        for window in windows:
            out = paged_decode_attention_cuda(q, k, v, table, q_pos, window)
            ref = paged_decode_attention_plain(q, k, v, table, q_pos, window)
            # every row, the idle one included: a MoE FFN routes it too
            err = check_kernel(torch, f"paged kernel ({tag}window={window})", out, ref)
            call = lambda w=window: paged_decode_attention_cuda(q, k, v, table, q_pos, w)
            if not torch.equal(out, call()):
                fail(f"paged kernel ({tag}window={window}) differs between two calls")
            check_one_kernel(torch, f"paged kernel ({tag}window={window})", call)
            t = timings(torch, call,
                        lambda w=window: paged_decode_attention_plain(q, k, v, table, q_pos, w),
                        None, 100)
            # the same entries in a dense cache through B2: the gather's cost
            kd, vd, kv_pos = paged_as_dense(torch, k, v, table)
            check_kernel(torch, f"dense yardstick of the paged case ({tag}window={window})",
                         decode_attention_cuda(q, kd, vd, kv_pos, q_pos, window), ref)
            dense_ms = device_ms(
                torch, lambda w=window: decode_attention_cuda(q, kd, vd, kv_pos, q_pos, w), 100)
            bound_ms, bound_by = paged_bound_ms(q, k, table, q_pos, live, window)
            rows["paged_decode_attention"][f"{tag}window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "dense_ms": dense_ms,
                "split": decode_split_of(torch, q, table.shape[1] * k.shape[1], k.shape[2])}

    # whisper-medium's decode self-attention (G = 1, hd 64: 16 / 16 heads;
    # B = 4 rows 32 + 16 deep) and llava-next-34b's (G = 7, hd 128: 56 / 8
    # heads; B = 2 rows 2880 + 64 + 8 deep), in the frontend phase's shared
    # form and per row; each in f32 too
    for form, windows, shape, tag in (("per_row", (None, 256), {}, ""),
                                      ("shared", (None, 256), {}, ""),
                                      ("per_row", (None,), granite, "granite,"),
                                      ("per_row", (None,), h2o, "h2o,"),
                                      ("shared", (None,), WHISPER_DECODE, "whisper,"),
                                      ("per_row", (None,), WHISPER_HEADS, "whisper,"),
                                      ("shared", (None,), LLAVA_DECODE, "llava,"),
                                      ("per_row", (None,), LLAVA_HEADS, "llava,")):
        if tag in ("whisper,", "llava,"):
            q, k, v, kv_pos, q_pos = dense_case(torch, form, dtype=f32, **shape)
            dense_f32_err = check_kernel(
                torch, f"dense decode kernel ({tag}{form}, float32)",
                decode_attention_cuda(q, k, v, kv_pos, q_pos, None),
                decode_attention_plain(q, k, v, kv_pos, q_pos, None), tol=F32_KERNEL_TOL)
            rows["decode_attention"][f"{tag}{form},float32"] = {"max_abs_err": dense_f32_err}
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
                             attn_mask=mask), 100)
            bound_ms, bound_by = dense_bound_ms(q, k, kv_pos, q_pos, window)
            rows["decode_attention"][f"{form},window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "split": decode_split_of(torch, q, k.shape[1], k.shape[2])}
    section("B1 / B2")

    # B3; h2o's prefill at hd 120 (padded to 128 in the kernel) on the tensor
    # cores; a ragged f32 prompt and an hd that is not a multiple of 8 on the
    # CUDA cores
    hd60 = {"Hq": 32, "Hkv": 8, "hd": 60}
    for S, windows, shape, tag, dt in ((512, (None, 256), {}, "", bf16),
                                       (333, (None, 256), {}, "", bf16),
                                       (333, (None,), granite, "granite,", bf16),
                                       (512, (None,), olmoe, "olmoe,", bf16),
                                       (2048, (None,), {}, "", bf16),
                                       (512, (None, 256), h2o, "h2o,", bf16),
                                       (97, (None,), h2o, "ragged,h2o,float32,", f32),
                                       (97, (None,), hd60, "hd60,", bf16)):
        q, k, v = flash_case(torch, S, dtype=dt, **shape)
        form = flash_attention_path(dt, q.shape[-1])
        tol = F32_KERNEL_TOL if dt == f32 else KERNEL_TOL
        for window in windows:
            name = f"flash kernel ({tag}S={S}, window={window})"
            out = flash_attention_cuda(q, k, v, True, window, 0)
            ref = flash_attention_plain(q, k, v, True, window, 0, 1024, 512)
            err = check_kernel(torch, name, out, ref, tol=tol)
            if not torch.equal(flash_attention_cuda(q, k, v, True, window, 0), out):
                fail(f"{name} differs between two calls")
            check_form(name, flash_attention_cuda,
                       lambda w=window: flash_attention_cuda(q, k, v, True, w, 0), form)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = (sdpa(torch, qt, kt, vt, is_causal=True) if window is None else
                   sdpa(torch, qt, kt, vt, attn_mask=flash_keep(torch, S, window)))
            t = timings(torch, lambda w=window: flash_attention_cuda(q, k, v, True, w, 0),
                        lambda w=window: flash_attention_plain(q, k, v, True, w, 0, 1024, 512),
                        lib, 30)
            bound_ms, bound_by = flash_bound_ms(torch, q, k, window)
            rows["flash_attention"][f"{tag}S={S},window={window}"] = {
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "form": form}
    if (flash_attention_path(bf16, 120), flash_attention_path(bf16, 60)) != ("mma", "simt"):
        fail("flash kernel: bf16 at hd 120 must take the tensor cores, at hd 60 the CUDA cores")
    rows["flash_attention"].update(frontend_flash_rows(torch))
    section("B3")

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
                    lambda a=args: lstm_cell_plain(*a), lib, 100)
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
                    lambda: moe_gmm_plain(x, next(ws)), lambda: torch.bmm(x, next(ws)), 100)
        bound_ms, bound_by = moe_gmm_bound_ms(x, w)
        rows["moe_gmm"][case] = {"max_abs_err": err, "library_err": lib_err, **t,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "path": moe_gmm_path(x, w)}

    section("B4 / B5")
    rows.update(scan_kernel_rows(torch))
    section("B6 / B7")
    rows.update(train_kernel_rows(torch))
    section("B3-bwd / B4-bwd")
    rows.update(family_bwd_kernel_rows(torch))
    section("B5 / B6 / B7 backward")
    rows.update(adamw_kernel_rows(torch))
    section("AdamW")

    for name, cases in rows.items():
        for case, r in cases.items():
            extra = "".join(f" {key}={r[key]}" for key in ("form", "split", "splits",
                                                            "dense_ms", "tiles", "fwd_bwd_ms",
                                                            "lse_err", "dx_ms", "dw_ms",
                                                            "library_dx_ms", "library_dw_ms",
                                                            "serving_ms", "bit_equal",
                                                            "row_ulps", "plain_err",
                                                            "plain_ulps", "fwd_ulps",
                                                            "norm_rel_err", "leaves")
                            if key in r)
            if "ms" not in r:                 # a correctness case, not timed
                log(f"kernel {name} {case}: max_abs_err={r['max_abs_err']:.3e}{extra}")
                continue
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"kernel {name} {case}: max_abs_err={r['max_abs_err']:.3e} ms={r['ms']:.4f} "
                f"(events {r['event_ms']:.4f}) plain_ms={r['plain_ms']:.4f} "
                f"library_ms={lib} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}){extra}")
    return rows


# the AdamW kernels' cases: (tag, arch, layers; None: all of them, timed)
ADAMW_CASES = (("h2o,1 layer", "h2o-danube3-4b", 1), ("granite,2 layers",
               "granite-moe-1b-a400m", 2), ("h2o,3.96B", "h2o-danube3-4b", None))
ADAMW_NORM_TOL = 1e-6           # relative: the kernels' norm sums in another order


def adamw_state(torch, arch: str, layers, seed: int = 9):
    """``arch``'s leaves at full width (``layers`` of its layers; None: all),
    random gradients N(0, 1e-3^2) in each parameter's dtype, and an AdamW
    state after a few steps: first moments N(0, 1e-4^2), second moments
    U(0, 1e-6) (zero moments would take the slow path of IEEE division),
    step 4."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.reduced(n_layers=layers)
    params = init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(p, fn, scale, dtype):
        return (fn(p.shape, generator=gen, device="cuda") * scale).to(dtype)

    grads = pytree.tree_map(lambda p: draw(p, torch.randn, 1e-3, p.dtype), params)
    opt = {"m": pytree.tree_map(lambda p: draw(p, torch.randn, 1e-4, torch.float32), params),
           "v": pytree.tree_map(lambda p: draw(p, torch.rand, 1e-6, torch.float32), params),
           "step": torch.tensor(4, dtype=torch.int32, device="cuda")}
    return params, grads, opt


def adamw_kernel_rows(torch) -> dict:
    """The AdamW kernels against the per-leaf loop (``ADAMW_CASES``): one
    update each from clones of the same p, m, v and gradients, the kernels
    given the loop's clip scale (clip 1.0: active); p, m and v must be bit
    for bit the loop's, the kernels' own norm within ADAMW_NORM_TOL of the
    loop's ``global_norm`` and the same bits twice.  All of h2o-danube3-4b's
    leaves then time (CUDA events) the kernels alone, back to back
    (``ms``), the whole ``adamw_update`` call (``event_ms``), the loop and
    the library's nearest calls: ``torch._foreach_norm`` for the clip, then ``torch._fused_adamw_``
    per dtype and decay group with the clip as its ``grad_scale``, its
    moments in the parameters' dtype (it holds no f32 moments for bf16
    parameters: another function, 14 B a bf16 element against 22)."""
    from unittest import mock

    from torch.utils import _pytree as pytree

    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim.adamw import AdamWConfig, _decayable, adamw_update

    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0)
    rows = {}
    for tag, arch, layers in ADAMW_CASES:
        params, grads, opt = adamw_state(torch, arch, layers)
        leaves = pytree.tree_leaves(params)
        if layers is not None:
            twin = pytree.tree_map(torch.clone, params)
            twin_opt = pytree.tree_map(torch.clone, opt)
            with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop"):
                _, _, ml = adamw_update(grads, twin, twin_opt, cfg)
            prep = adamw_ops.prepare(leaves, pytree.tree_leaves(grads),
                                     pytree.tree_leaves(opt["m"]), pytree.tree_leaves(opt["v"]),
                                     [False] * len(leaves))
            own = [adamw_ops.global_norm_cuda(*prep.norm, cfg.clip_norm) for _ in range(2)]
            with mock.patch.object(adamw_ops, "global_norm_cuda",
                                   lambda *a: (ml["grad_norm"], ml["clip_scale"])):
                adamw_update(grads, params, opt, cfg)
            torch.cuda.synchronize()
            pairs = list(zip(pytree.tree_leaves((params, opt["m"], opt["v"])),
                             pytree.tree_leaves((twin, twin_opt["m"], twin_opt["v"]))))
            same = all(bit_equal(torch, a, b) for a, b in pairs)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
            norm_err = abs(float(own[0][0]) / float(ml["grad_norm"]) - 1)
            repeat = all(bit_equal(torch, x, y) for x, y in zip(own[0], own[1]))
            if not (same and norm_err <= ADAMW_NORM_TOL and repeat
                    and float(ml["clip_scale"]) < 1):
                fail(f"AdamW kernels ({tag}): p, m, v bit-equal to the loop: {same} (max abs "
                     f"err {err}); norm {float(own[0][0])} vs the loop's "
                     f"{float(ml['grad_norm'])} (rel {norm_err:.3g} > {ADAMW_NORM_TOL}?), "
                     f"the same bits twice: {repeat}; clip scale {float(ml['clip_scale'])}")
            rows[tag] = {"max_abs_err": err, "bit_equal": same, "norm_rel_err": norm_err,
                         "leaves": len(leaves)}
            del twin, twin_opt, prep, own, ml, pairs
        else:
            # CUDA events throughout: a window of torch.profiler can drop one
            # of the update's ~27 ms records, and the count-scaled time then
            # reads low (26.8 ms against a 28.4 ms bound)
            paths = [k for k, _ in pytree.tree_flatten_with_path(params)[0]]
            prep = adamw_ops.prepare(leaves, pytree.tree_leaves(grads),
                                     pytree.tree_leaves(opt["m"]), pytree.tree_leaves(opt["v"]),
                                     [bool(cfg.weight_decay) and _decayable(p) for p in paths])
            scalars = [torch.tensor(x, dtype=torch.float32, device="cuda")
                       for x in (cfg.lr, 1 - cfg.b1 ** 5, 1 - cfg.b2 ** 5)]

            def kernels():
                _, scale = adamw_ops.global_norm_cuda(*prep.norm, cfg.clip_norm)
                adamw_ops.adamw_update_cuda(prep.tables, prep.chunks, prep.splits, scale,
                                            *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                                            weight_decay=cfg.weight_decay)

            library = library_adamw(torch, params, grads, paths, cfg, _decayable)
            t = {"ms": cuda_ms(kernels, 5), "event_ms": cuda_ms(
                     lambda: adamw_update(grads, params, opt, cfg), 5),
                 "plain_ms": cuda_ms(lambda: mock_loop(adamw_ops, lambda: adamw_update(
                     grads, params, opt, cfg)), 3, warmup=1),
                 "library_ms": cuda_ms(library, 5)}
            del prep, library
            bound_ms, bound_by = _fx_cost().bound_ms(0.0, adamw_bytes(leaves), BF16_FLOPS)
            rows[tag] = {"max_abs_err": 0.0, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                         "leaves": len(leaves),
                         "library_note": "torch._foreach_norm + torch._fused_adamw_ by dtype "
                                         "and decay, moments in the parameters' dtype; "
                                         "every time from CUDA events"}
        del params, grads, opt, leaves
        torch.cuda.empty_cache()
    return {"adamw": rows}


def mock_loop(adamw_ops, fn):
    """``fn()`` with AdamW's dispatch sent to the per-leaf loop (a plain
    function as the stand-in: a MagicMock would keep every call's leaves)."""
    from unittest import mock

    with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop"):
        return fn()


def library_adamw(torch, params, grads, paths, cfg, decayable):
    """The library's nearest AdamW, a callable: the global norm of
    ``torch._foreach_norm``'s per-leaf norms, the clip as
    ``torch._fused_adamw_``'s ``grad_scale`` (it divides each gradient by
    it), one call per parameter dtype and decay group, its moments in the
    parameters' dtype."""
    from torch.utils import _pytree as pytree

    ps, gs = pytree.tree_leaves(params), pytree.tree_leaves(grads)
    groups: dict = {}
    for path, p, g in zip(paths, ps, gs):
        key = (p.dtype, bool(cfg.weight_decay) and decayable(path))
        grp = groups.setdefault(key, ([], [], [], [], []))
        for lst, x in zip(grp, (p, g, torch.zeros_like(p), torch.zeros_like(p),
                                torch.ones((), device=p.device))):
            lst.append(x)

    def step():
        norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
        total = torch.linalg.vector_norm(torch.stack(norms))
        inv_scale = torch.clamp(total / cfg.clip_norm, min=1.0)
        for (_, decay), (p, g, m, v, steps) in groups.items():
            torch._fused_adamw_(p, g, m, v, [], steps, lr=cfg.lr, beta1=cfg.b1, beta2=cfg.b2,
                                weight_decay=cfg.weight_decay if decay else 0.0, eps=cfg.eps,
                                amsgrad=False, maximize=False, grad_scale=inv_scale,
                                found_inf=None)

    return step


def flash_bwd_bound_ms(torch, q, k, window, causal=True) -> tuple[float, str]:
    """Least time for one backward call: q, k, v, out, dout and lse read
    once, dq, dk and dv written once, over the HBM rate; or the
    kept pairs' five products (P recomputed, dP, dV, dK, dQ: 10 flops a
    pair a head-dim element) over the tensor-core rate of the dtype (the
    f32 rate for f32), whichever is larger.  Any Sq and Skv."""
    B, S, Hq, hd = q.shape
    pairs = int(flash_keep(torch, S, window, k.shape[1], causal).sum())
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.flash_bwd_work(B, S, k.shape[1], Hq, k.shape[2], hd,
                                           q.element_size(), pairs)
    return fx_cost.bound_ms(flops, nbytes, F32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS)


def sdpa_fwd_bwd(torch, q, k, v, do, window, causal=True):
    """PyTorch's fused attention forward and backward on the same inputs
    (its GQA form, a boolean mask for the window, no mask for a non-causal
    call): the yardstick of B3's forward + backward.  The port never calls
    it."""
    F = torch.nn.functional
    S = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    kw = ({} if not causal else {"is_causal": True} if window is None
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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.lstm_cell_bwd_work(N, H, gx.element_size(), c.element_size())
    return fx_cost.bound_ms(flops, nbytes, F32_FLOPS)


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
    of a key tile's query heads (``flash_bwd_splits``).  And at the
    frontend archs' training shapes (``FRONTEND_BWD``): non-causal with
    Sq != Skv (whisper's cross-attention: 448 text rows against 1500
    encoder rows, 23 key tiles + 28), non-causal Sq = Skv (its encoder),
    causal at G = 1, hd 64 (its decoder) and at G = 7, hd 128 (llava at
    training length and at its served prefill length), bf16 on the tensor
    cores.  There the answer is the plain version run in f32 on the same
    bf16 inputs: the training forward's output within ``BF16_ULPS`` bf16
    ulps of each row's largest value (``check_near_exact``) and its
    log-sum-exp within ``F32_KERNEL_TOL``; dq, dk and dv within
    ``BF16_BWD_ULPS`` (``bwd_row_ulps``; the bf16 plain version's own
    distance beside it).  B4's backward at the LSTM's N=64, H=1024, f32
    and with bf16 gates."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_path,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda,
                                                     flash_attention_train_cuda, flash_bwd_splits)
    from repro_torch.kernels.flash_attention.ops import _plain_forward
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda, lstm_cell_bwd_plain

    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict[str, dict] = {"flash_attention_bwd": {}, "lstm_cell_bwd": {}}
    # (case, (B, Sq, Skv, Hq, Hkv, hd, window, causal, dtype), frontend)
    cases = [(case, (B, S, S, Hq, Hkv, hd, window, True, dt), False)
             for case, (B, S, Hq, Hkv, hd, window, dt) in (
        ("B=4,S=512,window=None,bfloat16", (4, 512, 8, 1, 256, None, bf16)),
        ("B=4,S=512,window=256,bfloat16", (4, 512, 8, 1, 256, 256, bf16)),
        ("smoke,B=2,S=32,float32", (2, 32, 4, 1, 16, None, f32)),
        # granite-moe-1b-a400m's and recurrentgemma-2b's training shapes:
        # 16 / 8 heads of 64; 10 / 1 heads of 256 under its 2048 window
        ("granite,B=4,S=512,Hq=16,Hkv=8,hd=64,bfloat16", (4, 512, 16, 8, 64, None, bf16)),
        ("recurrentgemma,B=4,S=512,Hq=10,Hkv=1,hd=256,window=2048,bfloat16",
         (4, 512, 10, 1, 256, 2048, bf16)),
        # h2o-danube3-4b's training shape: 32 / 8 heads of 120 (the
        # kernels padded to 128); a ragged f32 call and an hd that is
        # not a multiple of 8 on the CUDA cores
        ("h2o,B=4,S=512,Hq=32,Hkv=8,hd=120,bfloat16", (4, 512, 32, 8, 120, None, bf16)),
        ("ragged,h2o,B=2,S=97,Hq=32,Hkv=8,hd=120,float32", (2, 97, 32, 8, 120, None, f32)),
        ("hd60,B=2,S=97,Hq=32,Hkv=8,hd=60,bfloat16", (2, 97, 32, 8, 60, None, bf16)))]
    cases += [(f"{tag},B={B},Sq={Sq},Skv={Skv},causal={causal},bfloat16",
               (B, Sq, Skv, heads["Hq"], heads["Hkv"], heads["hd"], None, causal, bf16), True)
              for B, Sq, Skv, causal, heads, tag in FRONTEND_BWD]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, (B, Sq, Skv, Hq, Hkv, hd, window, causal, dt), frontend in cases:
        name = f"flash backward kernel ({case})"
        if frontend:
            q, k, v, do = frontend_bwd_case(torch, B, Sq, Skv, Hq, Hkv, hd)
        else:
            gen = torch.Generator(device="cuda").manual_seed(8 + Sq + hd)
            q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            do = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").to(dt)
        tol = F32_KERNEL_TOL if dt == f32 else KERNEL_TOL
        out, lse = flash_attention_train_cuda(q, k, v, causal, window, 0)
        if not torch.equal(out, flash_attention_cuda(q, k, v, causal, window, 0)):
            fail(f"flash training forward ({case}) differs from the serving call")
        extra = {}
        if frontend:
            out_f32, lse_f32 = fwd_exact(torch, q, k, v, causal)
            extra["fwd_err"] = check_near_exact(torch, f"flash training forward ({case})", out,
                                                out_f32)
            extra["fwd_ulps"] = bf16_row_ulps(torch, out, out_f32)
            lse_err = check_kernel(torch, f"flash training forward lse ({case})", lse, lse_f32,
                                   tol=F32_KERNEL_TOL)
            del out_f32, lse_f32
        else:
            lse_err = check_kernel(torch, f"flash training forward lse ({case})", lse,
                                   _plain_forward(q, k, v, True, window, 0, 1024, 512)[1],
                                   tol=tol)
        args = (do, q, k, v, out, lse, causal, window, 0)
        got = flash_attention_bwd_cuda(*args)
        lib = sdpa_fwd_bwd(torch, q, k, v, do, window, causal)
        if frontend:
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(t).all()) for t in got):
                fail(f"{name} wrote non-finite values")
            ref = bwd_exact(torch, args)
            ulps, err = bwd_row_ulps(torch, got, ref)
            if not ulps <= BF16_BWD_ULPS:
                fail(f"{name} max abs err {err}: {ulps:.2f} bf16 ulps of its row's largest "
                     f"value, more than {BF16_BWD_ULPS}")
            extra["row_ulps"] = ulps
            extra["plain_ulps"], extra["plain_err"] = bwd_row_ulps(
                torch, flash_attention_bwd_plain(*args), ref)
        else:
            ref = flash_attention_bwd_plain(*args)
            err = max(check_kernel(torch, f"{name} {n}", a, b, tol=tol)
                      for n, a, b in zip(("dq", "dk", "dv"), got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd_cuda(*args))):
            fail(f"{name} differs between two calls")
        lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                      for a, b in zip(lib(), ref))
        del ref
        form = flash_attention_bwd_path(dt, hd)
        check_form(name, flash_attention_bwd_cuda, lambda a=args: flash_attention_bwd_cuda(*a),
                   "mma" if frontend else form)
        t = timings(torch, lambda a=args: flash_attention_bwd_cuda(*a),
                    lambda a=args: flash_attention_bwd_plain(*a), lib, 10,
                    plain_iters=3 if frontend else None)

        def fwd_bwd(q=q, k=k, v=v, do=do, window=window, causal=causal):
            o, l = flash_attention_train_cuda(q, k, v, causal, window, 0)
            return flash_attention_bwd_cuda(do, q, k, v, o, l, causal, window, 0)
        bound_ms, bound_by = flash_bwd_bound_ms(torch, q, k, window, causal)
        rows["flash_attention_bwd"][case] = {
            "max_abs_err": err, "lse_err": lse_err, "library_err": lib_err, **extra, **t,
            "fwd_bwd_ms": device_ms(torch, fwd_bwd, 10), "bound_ms": bound_ms,
            "bound_by": bound_by, "form": form,
            "splits": flash_bwd_splits(B, Skv, Hq, Hkv, sms)}
        del q, k, v, do, out, lse, got, lib

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
                    lambda a=args: lstm_cell_bwd_plain(*a), lib, 100)
        bound_ms, bound_by = lstm_cell_bwd_bound_ms(gx, c)
        rows["lstm_cell_bwd"][case] = {"max_abs_err": err, "library_err": lib_err, **t,
                                       "bound_ms": bound_ms, "bound_by": bound_by}
    return rows


def frontend_bwd_case(torch, B, Sq, Skv, Hq, Hkv, hd):
    """B3-bwd's bf16 inputs at a frontend shape (``FRONTEND_BWD``): q, k, v
    and dout, from a generator on the card seeded by the shape."""
    gen = torch.Generator(device="cuda").manual_seed(10 + Sq + Skv + hd)
    q, do = (torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v, do


def fwd_exact(torch, q, k, v, causal):
    """The plain forward run in f32 on the same bf16 inputs, a batch row at
    a time: its output and log-sum-exp, the answer B3's training forward
    is held to at the frontend shapes."""
    from repro_torch.kernels.flash_attention.ops import _plain_forward

    rows = [_plain_forward(*(t[b:b + 1].float() for t in (q, k, v)), causal, None, 0, 1024, 512)
            for b in range(q.shape[0])]
    return tuple(torch.cat(x) for x in zip(*rows))


def bwd_exact(torch, args):
    """The plain backward run in f32 on the same bf16 inputs (dout, q, k, v,
    the forward's output) and log-sum-exp, a batch row at a time (its f64
    score matrices at llava's 2944 are ~8 GB a row): the answer B3-bwd's
    bf16 frontend rows are held to."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    do, q, k, v, out, lse, *rest = args
    rows = [flash_attention_bwd_plain(*(t[b:b + 1].float() for t in (do, q, k, v, out)),
                                      lse[b:b + 1], *rest) for b in range(q.shape[0])]
    return tuple(torch.cat(g) for g in zip(*rows))


BWD_ROW_FLOOR = 2.0 ** -8       # a gradient row's scale: at least this share of the tensor's


def bwd_row_ulps(torch, got, exact) -> tuple[float, float]:
    """The largest |got - exact| over dq, dk and dv: in bf16 ulps of its
    output row's largest |exact| value, and absolute.  A row's largest
    value is floored at ``BWD_ROW_FLOOR`` of its tensor's largest: a
    gradient row can cancel to 0 (a causal call's first query row has
    one key, so dS = P (dP - D) = 0 and its dq is exactly 0), where any f32
    sum leaves ~1e-8 of rounding, which no ulp of 0 would hold."""
    return (max(bf16_row_ulps(torch, a, b, BWD_ROW_FLOOR) for a, b in zip(got, exact)),
            max((a.float() - b).abs().max().item() for a, b in zip(got, exact)))


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
    fx_cost = _fx_cost()
    flops, nbytes = fx_cost.moe_gmm_bwd_work(E, C, D, w.shape[2], x.element_size())
    return fx_cost.bound_ms(flops, nbytes, BF16_FLOPS if x.element_size() == 2 else F32_FLOPS)


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
        C = lc["pos"].shape[1]     # a ring of C entries (h2o's 16-token window): the last C
        for b, n in enumerate(lens):
            p = torch.arange(max(0, n - C), n, dtype=torch.int32)
            lc["pos"][b, (p % C).long()] = p
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


# the smoke h2o-danube3-4b at its full-width head dim: 2 / 1 heads of 120
H2O_HD120 = {"d_model": 240, "n_heads": 2, "n_kv_heads": 1}
# (arch, tag, smoke overrides) of the attention archs the small phases run
SMALL_DENSE_ARCHS = (("gemma-2b", "", {}), ("granite-moe-1b-a400m", "moe_", {}),
                     ("yi-9b", "yi_", {}), ("h2o-danube3-4b", "h2o_", {}),
                     ("h2o-danube3-4b", "h2o_hd120_", H2O_HD120),
                     ("command-r-plus-104b", "command_r_", {}))


def small_phase(torch) -> None:
    """The smoke gemma-2b, granite-moe-1b-a400m, yi-9b, h2o-danube3-4b (and
    an h2o smoke at its real head dim 120), command-r-plus-104b (parallel
    blocks), falcon-mamba-7b and recurrentgemma-2b configs in f32: captured
    steps on the card against
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

        for arch, tag, kw in SMALL_DENSE_ARCHS:
            cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32, **kw)
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
    log("small: smoke gemma-2b, granite-moe-1b-a400m (moe_), yi-9b (yi_), h2o-danube3-4b "
        "(h2o_; h2o_hd120_ at d_model 240, 2 / 1 heads of 120), command-r-plus-104b "
        "(command_r_), falcon-mamba-7b (mamba_), recurrentgemma-2b (griffin_) and a 2x5 LSTM, "
        "f32, card vs CPU max abs err "
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
SMALL_TRAIN_ARCHS = (("gemma-2b", "gemma", {}), ("granite-moe-1b-a400m", "moe", {}),
                     ("falcon-mamba-7b", "mamba", {}), ("recurrentgemma-2b", "griffin", {}),
                     ("yi-9b", "yi", {}), ("h2o-danube3-4b", "h2o", {}),
                     ("h2o-danube3-4b", "h2o_hd120", H2O_HD120),
                     ("command-r-plus-104b", "command_r", {}),
                     ("whisper-medium", "whisper", {}), ("llava-next-34b", "llava", {}))


def adamw_launches(leaves: int) -> int:
    """The AdamW kernels' launches for a tree of ``leaves`` leaves: the
    norm's partial sums and the update once a table of up to MAX_LEAVES
    leaves, the norm's finish once."""
    from repro_torch.kernels.adamw import MAX_LEAVES

    return 2 * -(-leaves // MAX_LEAVES) + 1


def train_launches(cfg, remat: bool, leaves: int = 0) -> dict:
    """The launches of each training kernel in one loss + gradient of
    ``cfg`` and, given its tree's ``leaves``, one AdamW update: per
    attention layer B3's training forward and its backward
    (whisper's decoder layers two of each: self- and cross-attention; its
    encoder layers one, never recomputed), per FFN of a MoE arch three B5
    products and three backwards, per Mamba layer one B6 training forward
    and one backward, per RG-LRU layer one B7 and one backward; remat runs
    every decoder layer's forward twice.  llava counts as a dense decoder.
    Every other kernel (B3's and B6's serving forms included): 0."""
    kinds = cfg.layer_kinds()
    fwd = 2 if remat else 1
    attn, ssm, rglru = kinds.count("attn"), kinds.count("ssm"), kinds.count("rglru")
    moe = 3 * (attn + rglru) if cfg.n_experts else 0
    dec = attn * (2 if cfg.cross_attention else 1)
    enc = cfg.n_encoder_layers
    return {"flash_attention_train": fwd * dec + enc, "flash_attention_bwd": dec + enc,
            "moe_gmm": fwd * moe, "moe_gmm_bwd": moe, "ssm_scan_train": fwd * ssm,
            "ssm_scan_bwd": ssm, "rglru_scan": fwd * rglru, "rglru_scan_bwd": rglru,
            "adamw": adamw_launches(leaves) if leaves else 0}


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
    """The smoke gemma-2b, granite-moe-1b-a400m, falcon-mamba-7b,
    recurrentgemma-2b, yi-9b, h2o-danube3-4b (and at hd 120),
    command-r-plus-104b, whisper-medium and llava-next-34b configs in f32
    (the frontends' batches with their frames or image rows, numpy drawn),
    each: the loss (for granite, its MoE load-balancing loss too) and every
    gradient (whisper's encoder and cross-attention leaves included) of one
    batch on the card
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
    for arch, tag, kw in SMALL_TRAIN_ARCHS:
        t0 = time.perf_counter()
        out[tag] = small_train_arch(torch, arch, tag, kw)
        out[tag]["seconds"] = time.perf_counter() - t0
    return out


def small_train_arch(torch, arch: str, tag: str, kw: dict) -> dict:
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

    cfg = get_config(arch, smoke=True).reduced(dtype=torch.float32, **kw)
    B, S = SMALL_TRAIN_B, SMALL_TRAIN_S
    shape = ShapeSpec("small_train", S, B, "train")
    rng = np.random.default_rng(5)
    # the text's tokens and labels (llava's image rows take part of S) and
    # the frontend's embeddings, in the shapes input_specs gives
    specs = model_api.input_specs(cfg, shape, device="cpu")
    S_text = specs["tokens"].shape[1]
    toks = rng.integers(0, cfg.vocab_size, (B, S_text + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :S_text].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    for k in sorted(set(specs) - set(batch)):
        batch[k] = torch.from_numpy(rng.standard_normal(tuple(specs[k].shape))
                                    .astype(np.float32))
    cpu = transformer.init_params(cfg, 0, device="cpu")

    def cuda(tree):
        return pytree.tree_map(lambda t: t.cuda(), tree)

    vg = value_and_grad(lambda p, b: model_api.lm_loss(cfg, p, b), has_aux=True,
                        unread=transformer.unread_params(cfg))
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
        n_attn = train_launches(cfg, remat=False)["flash_attention_train"]
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
    eager = pytree.tree_leaves(value_and_grad(lm_loss_fn(cfg), unread=transformer.unread_params(
        cfg))(cuda(cpu), cuda(batch)))
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
    log(f"small train: smoke {arch} ({tag}) f32, B={B} S={S}: loss, aux + {len(errs) - 2} "
        f"gradients card vs CPU max abs err {max(errs):.3e}; launches "
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
                          "flash_attention_bwd", "flash_attention_bwd.mma", "adamw")})
        return out

    n_leaves = len(pytree.tree_leaves(state["params"]))
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
                     "flash_attention_bwd": L, "flash_attention_bwd.mma": L,
                     "adamw": adamw_launches(n_leaves)}:
                fail(f"train step {i}: launches {c}, not {2 * L} B3 training forwards and "
                     f"{L} backwards, all mma, and {adamw_launches(n_leaves)} AdamW kernels")
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
    # profiler, and the AdamW update alone (kernels and loop, CUDA events)
    batch = data.batch(0)
    prof = profile_calls(torch, lambda: step(trainer.state, batch), "train", 1, "train step")
    opt = {k: trainer.state[k] for k in ("m", "v", "step")}
    adamw = adamw_timing(torch, trainer.state["params"], opt, tcfg.adamw)
    log(f"train: one AdamW update of the {n_params / 1e9:.3f}B parameters takes "
        f"{adamw['fused_ms']:.1f} ms in the multi-tensor kernels "
        f"({per_step[0]['adamw']} launches a step), {adamw['plain_ms']:.1f} ms in the per-leaf "
        f"loop; bound {adamw['bound_ms']:.1f} ms ({adamw['bytes'] / 1e9:.1f} GB at 3.35 TB/s; "
        f"CUDA events, host launch included)")
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
           "adamw_ms": adamw["fused_ms"], "adamw": adamw,
           "launches": {"flash_attention": totals["flash_attention_train"],
                        "flash_attention.mma": totals["flash_attention_train.mma"],
                        "flash_attention_bwd": totals["flash_attention_bwd"],
                        "flash_attention_bwd.mma": totals["flash_attention_bwd.mma"],
                        "adamw": totals["adamw"]}}
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


def adamw_timing(torch, params, opt: dict, cfg, iters: int = 2) -> dict:
    """One AdamW update of ``params`` from random gradients (N(0, 1e-3^2),
    in each parameter's dtype; all-zero moments would take the slow path of
    IEEE division) with CUDA events, host launch included, through the
    multi-tensor kernels and through the per-leaf loop, beside the update's
    bandwidth bound (``adamw_bytes``).  The state moves; the kernels are
    held to the loop in the kernel phase (``adamw_kernel_rows``)."""
    from unittest import mock

    from repro_torch.analysis import fx_cost
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim.adamw import adamw_update
    from torch.utils import _pytree as pytree

    grads = pytree.tree_map(lambda p: torch.randn_like(p) * 1e-3, params)
    leaves = pytree.tree_leaves(params)
    nbytes = adamw_bytes(leaves)

    def step():
        adamw_update(grads, params, opt, cfg)

    fused_ms = cuda_ms(step, iters, warmup=1)
    # a plain function, not a MagicMock: a mock would keep every call's
    # arguments (the whole state) alive after the timing
    with mock.patch.object(adamw_ops, "refusal", lambda *leaves: "the loop, timed"):
        plain_ms = cuda_ms(step, iters, warmup=1)
    del grads
    return {"fused_ms": fused_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": fx_cost.bound_ms(0.0, nbytes, BF16_FLOPS)[0], "leaves": len(leaves)}


def adamw_bytes(leaves) -> int:
    """The AdamW kernels' least traffic over ``leaves`` (gradients of the
    parameters' dtype): each element's p read and written, g read twice
    (the norm, the update), m and v (f32) read and written."""
    return sum(p.numel() * (4 * p.element_size() + 16) for p in leaves)


# the families trained at B=4, S=512 after gemma-2b: (arch, tag, layers);
# falcon-mamba-7b's 64 layers (7.27 B parameters, ~87 GB of bf16 weights and
# gradients and f32 AdamW moments) are cut to FALCON_TRAIN_LAYERS, width kept:
# 32 layers peaked at 53.6 GB on an H100 80GB HBM3 and each layer adds ~1.26
# GB (105 M parameters at 12 bytes), so 44 leave ~11 GB of the card free
FALCON_TRAIN_LAYERS = 44
FAMILY_TRAIN = (("granite-moe-1b-a400m", "moe_train", None),
                ("recurrentgemma-2b", "griffin_train", None),
                ("falcon-mamba-7b", "mamba_train", FALCON_TRAIN_LAYERS),
                # 3.96 B parameters at full width, ~48 GB with AdamW; B3 and
                # B3-bwd at hd 120 on the tensor cores
                ("h2o-danube3-4b", "h2o_train", None))
# the frontend archs trained after them: (arch, tag, layers, S); whisper-medium
# whole (1.013 B parameters) at its decoder's 448-token context beside 1500
# encoder frames; llava-next-34b at full width cut to LLAVA_TRAIN_LAYERS of
# its 60 layers (0.92 B of embeddings + ~0.558 B a layer: 60 need ~34.4 B,
# ~440 GB with AdamW) at S=512, 256 image rows + 256 text tokens
# (token_counts): on an H100 80GB HBM3 6 layers (4.27 B) peaked at 58.87 GB
# allocated and 8 (5.38 B) at 71.99 GB (75.08 GB reserved of 85.02), ~9.9
# GB free; a 9th layer's ~7 GB would leave under 8
LLAVA_TRAIN_LAYERS = 8
FRONTEND_TRAIN = (("whisper-medium", "whisper_train", None, 448),
                  ("llava-next-34b", "llava_train", LLAVA_TRAIN_LAYERS, TRAIN_S))


def family_train_phase(torch, arch: str, tag: str, n_layers, S: int = TRAIN_S) -> dict:
    """``arch`` at full width (its published config; depth cut to
    ``n_layers`` where given), random weights from seed 0, through
    ``make_train_step`` and the ``Trainer``: TRAIN_STEPS AdamW steps on
    the bigram stream at B=4, S (512 unless given) rows, remat on (no
    checkpoint: the gemma phase holds save and restore).  A frontend
    arch's batch function adds the embeddings ``make_batch`` draws (from a
    generator seeded 0 on the card) to the stream's tokens: whisper's
    frames ``[4, 1500, 1024]``, llava's image rows ahead of ``S - n_img``
    text tokens.  Gates: every loss, MoE aux and gradient norm finite; a
    MoE arch's loss equal to ce + 0.01·aux, with aux > 0; per step exactly
    the launches ``train_launches(cfg, remat=True, leaves)`` gives (B3, B5,
    B6, B7 forward twice and backward once a decoder layer; whisper's
    encoder once each; the AdamW kernels' 3) and no other kernel's; B3's ops by kind (self, encoder,
    cross) in one more step under ``flash_op_kinds``; every B3 and B5
    launch, forward and backward, on the tensor-core form.  Prints ms/step p50, tokens/s (text tokens;
    positions/s counts image rows and frames too), peak memory and where
    one more step's device time goes (``torch.profiler``)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models.api import make_batch, model_train_flops, token_counts
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None and n_layers != cfg.n_layers:
        cfg = cfg.reduced(n_layers=n_layers)
    B, steps = TRAIN_B, TRAIN_STEPS
    shape = ShapeSpec("train", S, B, "train")
    S_text = token_counts(cfg, shape)[1]
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

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S_text, global_batch=B,
                                      kind="bigram"))
    embeds = {k: t for k, t in make_batch(cfg, shape, torch.Generator(device="cuda").manual_seed(
        0), kind="train").items() if k not in ("tokens", "labels")}

    def batch_for_step(i):
        return {**data.batch(i), **embeds}

    trainer = Trainer(counted, state, batch_for_step,
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
    n_leaves = len(pytree.tree_leaves(state["params"]))
    want = {k: v for k, v in train_launches(cfg, remat=True, leaves=n_leaves).items() if v}
    for i, c in enumerate(per_step):
        check_train_launches(f"{tag} step {i}", c, want)
    check_kernel_forms(tag, totals, "mma", [k for k in TRAIN_FORMS if totals[k]])
    # B3 by kind in one more step, outside the timed run: the decoder's
    # self-attention and whisper's cross-attention recomputed under remat,
    # its encoder not
    batch = batch_for_step(0)
    n_self = cfg.layer_kinds().count("attn")
    n_cross = n_self if cfg.cross_attention else 0
    by_kind = {"train": {"self": 2 * n_self, "encoder": cfg.n_encoder_layers,
                         "cross": 2 * n_cross},
               "bwd": {"self": n_self, "encoder": cfg.n_encoder_layers, "cross": n_cross}}
    with flash_op_kinds() as kinds:
        step(trainer.state, batch)
        torch.cuda.synchronize()
    if kinds.n != by_kind:
        fail(f"{tag}: B3 ops by kind in a step {kinds.n}, not {by_kind}")
    prof = profile_calls(torch, lambda: step(trainer.state, batch), tag, 1, "train step")
    times = [r["time_s"] for r in recs]
    p50 = statistics.median(times)
    flops = model_train_flops(cfg, shape)
    positions = B * (S + cfg.encoder_len if cfg.frontend == "audio" else S)
    res = {"arch": arch, "layers": cfg.n_layers, "full_layers": full_layers, "steps": steps,
           "batch": B, "seq": S, "text_tokens": S_text, "remat": True, "n_params": n_params,
           "losses": [r["loss"] for r in recs], "ce": [r["ce"] for r in recs],
           "aux": [r["aux"] for r in recs], "grad_norms": [r["grad_norm"] for r in recs],
           "step_s": times, "ms_per_step_p50": 1e3 * p50, "tokens_per_s": B * S_text / p50,
           "positions_per_s": positions / p50,
           "model_tflops_per_s": flops / p50 / 1e12, "peak_memory_gb": peak_gb,
           "state_gb": state_gb, "run_s": run_s, "launches_per_step": per_step,
           "flash_by_kind_per_step": by_kind,
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
        f"{res['tokens_per_s']:.0f} tokens/s ({res['positions_per_s']:.0f} positions/s), "
        f"{res['model_tflops_per_s']:.1f} TFLOP/s by 6ND; peak memory {peak_gb:.2f} GB; "
        f"launches per step {per_step[0]}; B3 ops by kind a step {by_kind}")
    del trainer, state, embeds, batch
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 7: serve ------------------------------------------------------------

def flash_op_kinds():
    """A dispatch mode that counts B3's training forward and backward ops
    (``repro_torch::flash_attention_train``, ``flash_attention_bwd``) by
    the attention each serves, read from its arguments by name: ``self``
    (causal), ``encoder`` (non-causal, Sq = Skv: whisper's encoder) and
    ``cross`` (non-causal, Sq != Skv).  It sees the ops of the thread that
    opens it and of the backward that thread starts; every other op on
    that thread passes through it too, so a timed run stays outside."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class FlashOpKinds(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {op: {"self": 0, "encoder": 0, "cross": 0} for op in ("train", "bwd")}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            op = {"flash_attention_train": "train", "flash_attention_bwd": "bwd"}.get(
                func.overloadpacket.__name__) if func.namespace == "repro_torch" else None
            if op is not None:
                a = {**dict(zip((x.name for x in func._schema.arguments), args)), **kwargs}
                q, k = a["q"], a["k"]
                self.n[op]["self" if a["causal"] else
                           "encoder" if q.shape[1] == k.shape[1] else "cross"] += 1
            return func(*args, **kwargs)

    return FlashOpKinds()


def launch_counts() -> dict:
    from repro_torch.kernels.adamw import adamw_update_cuda, global_norm_cuda
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

    return {"adamw": global_norm_cuda.launches + adamw_update_cuda.launches,
            "paged_decode_attention": paged_decode_attention_cuda.launches,
            "decode_attention": decode_attention_cuda.launches,
            "decode_attention.shared": decode_attention_cuda.launches_by_form["shared"],
            "decode_attention.per_row": decode_attention_cuda.launches_by_form["per_row"],
            "decode_attention.lse": decode_attention_cuda.launches_by_form.get("lse", 0),
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
    from repro_torch.kernels.adamw import adamw_update_cuda, global_norm_cuda
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

    global_norm_cuda.launches = 0
    adamw_update_cuda.launches = 0
    paged_decode_attention_cuda.launches = 0
    decode_attention_cuda.launches = 0
    decode_attention_cuda.launches_by_form = {"shared": 0, "per_row": 0, "lse": 0}
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
    check = check_engine(torch, eng, "paged")
    check["planted"] = planted_chunk_check(torch, eng, rt)

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
            "three_way": three, "check": check}


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
    check = check_engine(torch, eng, "slot")
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
            "engine_build_s": setup_s, "three_way": three, "slot_update_ms": copy_ms,
            "check": check}


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
    prompts = moe_prompts(cfg)
    new_tokens = 16
    out: dict[str, dict] = {}

    eng, rt, res = serve_paged(torch, cfg, params, prompts, new_tokens, "moe paged")
    launches, st = res["launches"], res["stats"]
    moe_launch_check("paged", cfg, launches, st["n_decode_steps"] + st["n_chunks"])
    if launches["paged_decode_attention"] != cfg.n_layers * st["n_decode_steps"]:
        fail(f"moe paged: B1 launched {launches['paged_decode_attention']} times")
    check_paged_decode(torch, eng, rt, res, "moe paged")
    out["paged"] = res
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
    their buckets (exact lengths: MoE and recurrent archs; powers of two
    for dense ones) captured up front, then 4 requests, one step and the
    rest, so admissions overlap decode steps; the launch counts set to 0
    just before serving and read just after.  Returns (engine, its runtime,
    result)."""
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
    buckets = sorted({eng._prefill_bucket(n) for n in lens})
    if sorted(eng._prefill_exes) != buckets:
        fail(f"{what}: prefill graphs {sorted(eng._prefill_exes)}, not the buckets {buckets} "
             f"of the prompt lengths {lens}")
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


def serve_paged(torch, cfg, params, prompts, new_tokens: int, what: str):
    """The PagedEngine over ``prompts``: request 0 prefills first, so the
    others map its 128-token prefix pages, then the rest; the launch counts
    set to 0 just before serving and read just after.  Returns (engine, its
    runtime, result)."""
    import repro_torch
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, PagedEngine, Request, ServeConfig

    rt = Runtime(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = repro_torch.serve_engine(cfg, params, ServeConfig(max_batch=8, max_len=1024),
                                   paged=PagedConfig(page_size=16, prefill_chunk=128),
                                   device="cuda", runtime=rt)
    if not isinstance(eng, PagedEngine):
        fail(f"{what}: serve_engine gave {type(eng).__name__}")
    setup_s = time.perf_counter() - t0
    log(f"{what}: engine built in {setup_s:.1f}s {json.dumps(eng.setup_s)}; "
        f"n_executors={eng.n_executors} decode nodes={len(eng._decode_exe.graph)} "
        f"chunk nodes={len(eng._chunk_exe.graph)}")
    check = check_engine(torch, eng, what)
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
    res = serve_result(what, eng, done, len(prompts), new_tokens, cfg.vocab_size, wall,
                       launch_counts(), setup_s)
    if res["stats"]["n_shared_pages"] < 8:
        fail(f"{what}: the 128-token prefix was not shared ({res['stats']})")
    res.update({"setup_s": eng.setup_s, "decode_nodes": len(eng._decode_exe.graph),
                "check": check})
    return eng, rt, res


def check_paged_decode(torch, eng, rt, res: dict, what: str) -> None:
    """The paged engine's decode step run three ways on a random paged
    cache, a profile of a few steps, the peak memory; then its runtime
    closes."""
    import numpy as np

    three, inputs = three_way_decode(torch, eng, np.random.default_rng(5), what)
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

# (arch, tag, layers or None for all): falcon-mamba-7b serves 16 of its 64
# layers at full width, so that the whole run, the dist phase included,
# stays under the 1200 s limit (on an H100 80GB HBM3 at 700 W the 64-layer
# serve took 52.1 s of a 635.0 s run, 32 layers 21.7 s of 811.3 s); every
# Mamba layer is alike
FALCON_SERVE_LAYERS = 16
RECURRENT = (("falcon-mamba-7b", "mamba", FALCON_SERVE_LAYERS),
             ("recurrentgemma-2b", "griffin", None))


def build_recurrent_model(torch, arch: str, tag: str, n_layers=None):
    """``arch`` at its published width (depth cut to ``n_layers`` where
    given), random weights from seed 0 (the f32 leaves — Mamba's A_log, D,
    dt_bias, RG-LRU's lam — f32, everything else bf16)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.reduced(n_layers=n_layers)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    kinds = {k: cfg.layer_kinds().count(k) for k in sorted(set(cfg.layer_kinds()))}
    log(f"{tag}: {arch} {cfg.n_layers}x{cfg.d_model} kinds {json.dumps(kinds)} d_inner "
        f"{cfg.d_inner} state {cfg.ssm_state} rnn {cfg.rnn_width} vocab {cfg.vocab_size}: "
        f"{n_params / 1e9:.3f}B params in {time.perf_counter() - t0:.1f}s")
    return cfg, params, n_params


def model_launch_check(what: str, cfg, launches: dict, calls: int, decode_steps: int,
                       decode_kernel: str) -> None:
    """Every model call (prefill or decode step) ran every layer once: B6
    per Mamba layer, B7 per RG-LRU layer, B3 per attention layer in a
    prefill and ``decode_kernel`` (B2 in one form, or B1) per attention
    layer in a decode step, and no other launches of them.  A paged
    engine's prompt chunks are no such calls: their attention is no B3."""
    kinds = cfg.layer_kinds()
    prefills = calls - decode_steps
    want = {"ssm_scan": kinds.count("ssm") * calls, "rglru_scan": kinds.count("rglru") * calls,
            "flash_attention": kinds.count("attn") * prefills,
            decode_kernel: kinds.count("attn") * decode_steps}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{what}: {name} launched {launches[name]} times, not {n} ({calls} model "
                 f"calls, {decode_steps} of them decode steps, kinds {sorted(set(kinds))})")


def recurrent_serve_phase(torch, arch: str, tag: str, n_layers) -> dict:
    """One recurrent arch at full width (depth cut to ``n_layers`` where
    given) through the slot and wave engines,
    the same 8 greedy requests (16 new tokens each) in each; each engine's
    launch counts set to 0 just before it serves and read just after.  The
    paged engine must refuse the arch."""
    import repro_torch
    from repro_torch.serve import PagedConfig, ServeConfig

    cfg, params, n_params = build_recurrent_model(torch, arch, tag, n_layers)
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
    model_launch_check(f"{tag} slot", cfg, res["launches"], st["n_decode_steps"] + len(prompts),
                       st["n_decode_steps"], "decode_attention.per_row")
    check_slot_decode(torch, eng, rt, res, f"{tag} slot")
    out["slot"] = res
    del eng

    res = serve_wave(torch, cfg, params, prompts, new_tokens, f"{tag} wave")
    st = res["stats"]
    model_launch_check(f"{tag} wave", cfg, res["launches"], st["n_decode_steps"] + st["n_waves"],
                       st["n_decode_steps"], "decode_attention.shared")
    out["wave"] = res
    del params
    torch.cuda.empty_cache()
    return out


# -- phase 10: serve the zoo's other dense decoders ------------------------------

# (arch, tag, layers or None for all, engines), each at full width: yi-9b
# cut to ZOO_YI_LAYERS of its 48 layers and h2o-danube3-4b to ZOO_H2O_LAYERS
# of its 24 (B1 / B2 / B3 at hd 120), for the dist phase's time (the whole
# run stays under the 1200 s limit); command-r-plus-104b cut to 8 of its 64
# layers (~37.8 GB: 3.15 GB a layer and 12.6 GB of untied embed and
# unembed; 64 layers would need ~214 GB)
ZOO_YI_LAYERS = 16
ZOO_H2O_LAYERS = 8
ZOO = (("yi-9b", "yi", ZOO_YI_LAYERS, ("slot",)),
       ("h2o-danube3-4b", "h2o", ZOO_H2O_LAYERS, ("slot", "paged")),
       ("command-r-plus-104b", "command_r", 8, ("slot", "paged")))


def descendants(graph, name: str) -> set[str]:
    """Every node of ``graph`` reachable from ``name`` along its consumers
    (``name`` itself excluded)."""
    seen: set[str] = set()
    todo = list(graph.successors(name))
    while todo:
        n = todo.pop()
        if n not in seen:
            seen.add(n)
            todo.extend(graph.successors(n))
    return seen


def parallel_branches(captured, params) -> list[tuple[str, str]]:
    """For each layer of ``captured`` (a model step whose first argument is
    ``params``), in layer order: the node that reads
    ``layers[i]["attn"]["wo"]`` (the attention output projection) and the
    node that reads ``layers[i]["mlp"]["w_down"]`` (the FFN down product),
    found through the capture's map from argument leaf to input node."""
    from torch.utils import _pytree as pytree

    index = {id(t): j for j, t in enumerate(pytree.tree_leaves(params))}
    pairs = []
    for i, lp in enumerate(params["layers"]):
        found = []
        for what, w in (("attn wo", lp["attn"]["wo"]), ("mlp w_down", lp["mlp"]["w_down"])):
            users = captured.graph.successors(captured.input_names[index[id(w)]])
            if len(users) != 1:
                fail(f"layer {i}: {len(users)} nodes read its {what}, not one")
            found.append(users[0])
        pairs.append((found[0], found[1]))
    return pairs


def branch_streams(eng) -> dict:
    """How many layers of the engine's static decode plan put their
    attention output projection and their FFN down product on different
    executors (each executor is one CUDA stream), and whether any path
    joins the two (a parallel block has none)."""
    exe = eng._decode_exe
    plan = exe.host_plan(eng.n_executors)
    pairs = parallel_branches(exe.captured, eng.params)
    split = sum(plan.owner[plan.ids[a]] != plan.owner[plan.ids[b]] for a, b in pairs)
    joined = sum(b in descendants(exe.graph, a) or a in descendants(exe.graph, b)
                 for a, b in pairs)
    return {"layers": len(pairs), "on_two_streams": split, "joined_by_a_path": joined,
            "n_executors": plan.n_executors}


def zoo_serve_phase(torch, arch: str, tag: str, n_layers, engines) -> dict:
    """One dense decoder of the zoo at full width (depth cut to
    ``n_layers`` where given), random weights from seed 0, through the
    per-slot engine and, where ``engines`` names it, the paged engine: 8
    greedy requests of 4 x 200 and 4 x 333 prompt tokens (two sharing a
    128-token prefix), 16 new tokens each, slot admissions 4 + 4.  Launch
    counts set to 0 just before each engine serves and read just after, and
    exact per model call (B3 once a layer a slot prefill, B2 / B1 once a
    layer a decode step); each engine's decode step run three ways
    (static / dynamic / sequential, bit-identical) and profiled.  A parallel
    block's attention and FFN products: on how many layers the static
    decode plan put them on different streams."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = cfg.reduced(n_layers=n_layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    weights_gb = torch.cuda.memory_allocated() / 1e9
    log(f"{tag}: {arch} {cfg.n_layers} of {full_layers} layers x d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, window {cfg.sliding_window}, parallel block "
        f"{cfg.parallel_block}: {n_params / 1e9:.3f}B params, {weights_gb:.2f} GB on the card, "
        f"built in {time.perf_counter() - t0:.1f}s")
    prompts = moe_prompts(cfg)
    new_tokens = 16
    out: dict = {"arch": arch, "layers": cfg.n_layers, "full_layers": full_layers,
                 "n_params": n_params, "weights_gb": weights_gb}

    eng, rt, res = serve_slot(torch, cfg, params, prompts, new_tokens, f"{tag} slot")
    st = res["stats"]
    model_launch_check(f"{tag} slot", cfg, res["launches"], st["n_decode_steps"] + len(prompts),
                       st["n_decode_steps"], "decode_attention.per_row")
    if cfg.parallel_block:
        res["branches"] = branch_streams(eng)
        log(f"{tag} slot: parallel blocks in the static decode plan: {res['branches']}")
    check_slot_decode(torch, eng, rt, res, f"{tag} slot")
    out["slot"] = res
    del eng

    if "paged" in engines:
        eng, rt, res = serve_paged(torch, cfg, params, prompts, new_tokens, f"{tag} paged")
        st = res["stats"]
        model_launch_check(f"{tag} paged", cfg, res["launches"], st["n_decode_steps"],
                           st["n_decode_steps"], "paged_decode_attention")
        if cfg.parallel_block:
            res["branches"] = branch_streams(eng)
            log(f"{tag} paged: parallel blocks in the static decode plan: {res['branches']}")
        check_paged_decode(torch, eng, rt, res, f"{tag} paged")
        out["paged"] = res
        del eng
    del params
    torch.cuda.empty_cache()
    return out


# -- phase 11: serve the frontend archs through the serving steps -----------------

# (arch, tag, layers or None for all, batch rows, text tokens, new tokens):
# whisper-medium whole (24 encoder + 24 decoder layers, ~1.01 B params) and
# llava-next-34b at full width and 20 of its 60 layers (~12.1 B, ~24 GB; 60
# layers are ~68.8 GB of bf16 weights, and the host runtimes keep every
# node's result until a run ends), behind 2880 image rows
LLAVA_SERVE_LAYERS = 20
FRONTEND = (("whisper-medium", "whisper", None, 4, 32, 16),
            ("llava-next-34b", "llava", LLAVA_SERVE_LAYERS, 2, 64, 8))


class FlashKinds:
    """B3's serving launches by the attention each serves, read from its
    shapes: ``self`` (causal), ``encoder`` (non-causal, Sq = Skv: whisper's
    encoder) and ``cross`` (non-causal, Sq != Skv: cross-attention to the
    encoder's rows).  A tally beside the wrapper's own count (the phase
    checks the two agree), taken while the context is open at the launch
    helper both forward wrappers call, whose arguments it takes by name
    (so a change to them raises): a serving call passes no ``lse``."""

    def __enter__(self):
        import threading

        from repro_torch.kernels.flash_attention import ops

        self.ops, self.launch = ops, ops._forward_cuda
        self.counts = {"self": 0, "encoder": 0, "cross": 0}
        lock = threading.Lock()

        def tally(q, k, v, causal, window, q_offset, lse):
            out = self.launch(q, k, v, causal=causal, window=window, q_offset=q_offset, lse=lse)
            if lse is None:
                kind = "self" if causal else "encoder" if q.shape[1] == k.shape[1] else "cross"
                with lock:
                    self.counts[kind] += 1
            return out

        ops._forward_cuda = tally
        return self

    def __exit__(self, *exc):
        self.ops._forward_cuda = self.launch


def frontend_batch(torch, cfg, B: int, text: int) -> dict:
    """The prompt batch of the frontend phase, from a generator seeded 0 on
    the card: ``make_batch``'s for whisper (tokens and frames ``[B, 1500,
    1024]``); for llava its tokens and 2880 image rows drawn alike, since
    ``make_batch`` (as the reference's) caps the image rows at half the
    sequence and so gives no 64-token prompt behind all 2880."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import api

    gen = torch.Generator(device="cuda").manual_seed(0)
    if cfg.frontend == "audio":
        return api.make_batch(cfg, ShapeSpec("whisper", text, B, "prefill"), gen)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, text), generator=gen, device="cuda",
                                    dtype=torch.int32),
            "image_embeds": torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen,
                                        device="cuda").to(cfg.dtype)}


def greedy_steps(torch, cfg, params, batch, max_len: int, new_tokens: int, prefill, decode):
    """``new_tokens`` greedy tokens per row: one from ``prefill``'s logits,
    the rest from ``decode`` steps.  Returns (tokens [B, new_tokens] on the
    host, prefill s, host s of each decode step, the last step's inputs)."""
    from repro_torch.models import transformer
    from repro_torch.serve.step import sample_tokens

    cache = transformer.init_cache(cfg, batch["tokens"].shape[0], max_len, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, batch)
    tok = sample_tokens(logits, cfg.vocab_size, 0.0).to(torch.int32)
    toks = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    step_s, args = [], None
    for _ in range(new_tokens - 1):
        t1 = time.perf_counter()
        args = (params, cache, tok[:, None])
        logits, cache = decode(*args)
        tok = sample_tokens(logits, cfg.vocab_size, 0.0).to(torch.int32)
        toks.append(tok.cpu())
        step_s.append(time.perf_counter() - t1)
    return torch.stack(toks, dim=1), prefill_s, step_s, args


def frontend_serve_phase(torch, arch: str, tag: str, n_layers, B: int, text: int,
                         new_tokens: int) -> dict:
    """One frontend arch at full width (depth cut to ``n_layers`` where
    given), random weights from seed 0, through ``serve.step``'s prefill
    and decode steps with the frontend's embeddings (``frontend_batch``):
    eagerly, then captured by ``repro_torch.compile`` on a ``Runtime`` as
    the slot engine captures its steps (prefill under the dynamic
    scheduler, decode as a calibrated static plan); greedy tokens equal,
    launch counts set to 0 just before each run and read just after, exact
    per model call (B3 once a layer of the encoder, the decoder's
    self-attention and its cross-attention at prefill, once a
    cross-attention layer a decode step; B2 once a decoder layer a decode
    step), the decode step three ways (bit-identical) and profiled.  The
    slot and paged engines must refuse the arch, the wave engine serve it
    as text (llava: 2 x 64 and 2 x 96 tokens) or refuse it (whisper)."""
    import numpy as np
    from torch.utils import _pytree as pytree

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve import PagedConfig, Request, ServeConfig
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = cfg.reduced(n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    weights_gb = torch.cuda.memory_allocated() / 1e9
    batch = frontend_batch(torch, cfg, B, text)
    n_img = batch["image_embeds"].shape[1] if "image_embeds" in batch else 0
    max_len = n_img + text + new_tokens
    log(f"{tag}: {arch} {cfg.n_layers} of {full_layers} decoder layers + "
        f"{cfg.n_encoder_layers} encoder layers x d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params / 1e9:.3f}B params, {weights_gb:.2f} GB on the card, "
        f"built in {time.perf_counter() - t0:.1f}s; batch "
        f"{json.dumps({k: list(v.shape) for k, v in batch.items()})}")
    out: dict = {"arch": arch, "layers": cfg.n_layers, "full_layers": full_layers,
                 "encoder_layers": cfg.n_encoder_layers, "n_params": n_params,
                 "weights_gb": weights_gb, "batch": {k: list(v.shape) for k, v in batch.items()}}

    # the engines: slot and paged refuse, the wave engine refuses whisper;
    # each with its own refusal (engine keywords, the message's words)
    scfg = ServeConfig(max_batch=4, max_len=1024)
    refusals = {"slot": ({}, "continuous batching supports decoder-only"),
                "paged": ({"paged": PagedConfig(page_size=16)}, "paged serving requires")}
    if cfg.frontend == "audio":
        refusals["wave"] = ({"continuous": False}, "wave requests carry no encoder input")
    for what, (kw, words) in refusals.items():
        try:
            eng = repro_torch.serve_engine(cfg, params, scfg, device="cuda", **kw)
            eng.submit(Request(0, np.arange(1, 9, dtype=np.int32), max_new_tokens=2))
            eng.run()
        except ValueError as e:
            if words not in str(e):
                fail(f"{tag}: the {what} engine raised {e!r}, not its refusal ({words!r})")
            log(f"{tag} {what}: refused as in the reference: {e}")
        else:
            fail(f"{tag}: the {what} engine served {arch}")
    out["refused"] = sorted(refusals)

    n_cross = cfg.n_layers if cfg.cross_attention else 0
    steps = new_tokens - 1
    want = {"flash_attention": cfg.n_encoder_layers + cfg.n_layers + n_cross * (1 + steps),
            "decode_attention.shared": cfg.n_layers * steps, "decode_attention.per_row": 0,
            "paged_decode_attention": 0}
    want_kinds = {"self": cfg.n_layers, "encoder": cfg.n_encoder_layers,
                  "cross": n_cross * (1 + steps)}

    def checked(what: str, kinds: dict) -> dict:
        launches = launch_counts()
        for name, n in want.items():
            if launches[name] != n:
                fail(f"{tag} {what}: {name} launched {launches[name]} times, not {n}")
        if kinds != want_kinds:
            fail(f"{tag} {what}: B3 launches by kind {kinds}, not {want_kinds}")
        return launches

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    reset_launch_counts()
    with FlashKinds() as fk:
        toks, prefill_s, step_s, _ = greedy_steps(torch, cfg, params, batch, max_len,
                                                  new_tokens, prefill, decode)
    eager = {"launches": checked("eager", fk.counts), "b3_by_kind": dict(fk.counts),
             "prefill_s": prefill_s, "decode_p50_ms": 1e3 * statistics.median(step_s),
             "decode_step_ms": [1e3 * x for x in step_s],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{tag} eager: a token id outside the vocabulary")
    log(f"{tag} eager: prefill {prefill_s:.3f}s, decode step p50 {eager['decode_p50_ms']:.1f} ms "
        f"over {steps} steps, peak {eager['peak_mem_gb']:.2f} GB; B3 by kind "
        f"{json.dumps(fk.counts)}; launches {json.dumps(eager['launches'])}; first tokens "
        f"{toks[:, :6].tolist()}")
    out["eager"] = eager

    rt = Runtime(device="cuda")
    t0 = time.perf_counter()
    cache0 = transformer.init_cache(cfg, B, max_len, device="cuda")
    tok0 = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pexe = repro_torch.compile(prefill, params, cache0, batch, backend="host", jit_nodes=True,
                               runtime=rt, name=f"{tag}_prefill")
    dexe = repro_torch.compile(decode, params, cache0, tok0, backend="host", jit_nodes=True,
                               host_mode="static", runtime=rt, name=f"{tag}_decode")
    t1 = time.perf_counter()
    dexe.calibrate(params, cache0, tok0)
    n_exec = max(1, min(dexe.planned_executors, rt.n_workers))
    dexe.host_plan(n_exec)
    setup = {"capture_s": t1 - t0, "calibrate_s": time.perf_counter() - t1}

    def run(exe, mode):
        def call(*args):
            res = exe.execute_host(exe.captured.bind(args), n_executors=n_exec, host_mode=mode)
            return exe.captured.unflatten(res.outputs)
        return call

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with FlashKinds() as fk:
        ctoks, prefill_s, step_s, last = greedy_steps(torch, cfg, params, batch, max_len,
                                                      new_tokens, run(pexe, "dynamic"),
                                                      run(dexe, "static"))
    compiled = {"launches": checked("compiled", fk.counts), "b3_by_kind": dict(fk.counts),
                "prefill_s": prefill_s, "decode_p50_ms": 1e3 * statistics.median(step_s),
                "decode_step_ms": [1e3 * x for x in step_s],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "setup_s": setup,
                "n_executors": n_exec, "prefill_nodes": len(pexe.graph),
                "decode_nodes": len(dexe.graph)}
    if not torch.equal(ctoks, toks):
        fail(f"{tag}: compiled tokens {ctoks.tolist()} differ from eager {toks.tolist()}")
    log(f"{tag} compiled: {len(pexe.graph)} prefill / {len(dexe.graph)} decode nodes, "
        f"{n_exec} executors, set-up {json.dumps(setup)}; prefill {prefill_s:.3f}s, decode step "
        f"p50 {compiled['decode_p50_ms']:.1f} ms, peak {compiled['peak_mem_gb']:.2f} GB; tokens "
        f"equal to eager")
    three, inputs = three_way(torch, dexe, n_exec, last, f"{tag} decode",
                              (B, cfg.padded_vocab))
    compiled.update({"three_way": three,
                     "trace": profile_static(torch, dexe, n_exec, inputs, f"{tag} decode", 3,
                                             "decode step")})
    out["compiled"] = compiled
    rt.close()
    del pexe, dexe, last, inputs

    if cfg.frontend == "vision":             # llava as text, as the reference serves it
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (64, 96) * 2]
        res = serve_wave(torch, cfg, params, prompts, new_tokens, f"{tag} wave")
        st = res["stats"]
        model_launch_check(f"{tag} wave", cfg, res["launches"],
                           st["n_decode_steps"] + st["n_waves"], st["n_decode_steps"],
                           "decode_attention.shared")
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


# -- the hazard checks (A12) and the hwperf layer (A13) ---------------------------

def check_engine(torch, eng, what: str) -> dict:
    """The serving CLI's ``--check`` over an engine the serve phases built
    (no second build): ``verify(hazards=True)`` over its decode graph (and
    chunk graph), and for a paged engine the decode × chunk pair over its
    one page pool.  No error finding; a paged pair has no H-XWW, its decode
    graph writes every pool leaf (an error otherwise) and its chunk graph
    is read-only over them (C-RO)."""
    from repro_torch.checks.cli import verify_engine

    t0 = time.perf_counter()
    rep = verify_engine(eng)
    verify_s = time.perf_counter() - t0
    rules = rep.by_rule()
    if not rep.ok:
        fail(f"{what}: check found errors: {rep.render(min_severity='error')[:3000]}")
    paged = getattr(eng, "_chunk_exe", None) is not None
    if paged and ("C-RO" not in rules or "H-XOK" not in rules or rules.get("H-XWW")):
        fail(f"{what}: the paged pair was not certified: {json.dumps(rules)}")
    log(f"{what}: check: {rep.summary()} {json.dumps(rules)}; {len(rep)} findings; "
        f"verify adds {verify_s:.2f}s to set-up")
    return {"findings": len(rep), "errors": len(rep.errors), "rules": rules,
            "verify_s": verify_s}


def planted_chunk_check(torch, eng, rt) -> dict:
    """Copies of the paged engine's chunk graph that also write into a
    pool, captured on the card over the engine's pool tensors (fake
    tracing: the pool itself is not touched): one out of place
    (``index_put``), one in place through a view (``k[0] = k[1]``, traced as
    ``select`` then ``copy_``).  For each the pair check must report H-XWW
    and ``strict`` must refuse it."""
    import repro_torch
    from torch.utils import _pytree as pytree

    from repro_torch.checks.cli import paged_binds, paged_pair_report
    from repro_torch.core.graph import GraphValidationError
    from repro_torch.serve.step import make_prefill_chunk_step

    honest = make_prefill_chunk_step(eng.cfg, eng.pcfg.page_size)

    def index_put(k0):
        first = torch.zeros(1, dtype=torch.long, device=k0.device)
        return k0.index_put((first,), k0.index_select(0, first + 1))

    def view_write(k0):
        k0[0] = k0[1]

    i32 = {"dtype": torch.int32, "device": "cuda"}
    res = {}
    for plant in (index_put, view_write):
        def planted(params, pages, table_row, batch, start, valid_len, _plant=plant):
            out = honest(params, pages, table_row, batch, start, valid_len)
            return out, _plant(pages[0]["k"])

        t0 = time.perf_counter()
        exe = repro_torch.compile(
            planted, eng.params, eng._pages, torch.full((eng.n_pt,), -1, **i32),
            {"tokens": torch.zeros((1, eng.chunk), **i32)}, torch.tensor(0, **i32),
            torch.tensor(eng.chunk, **i32), runtime=rt, n_executors=eng.n_executors,
            team_size=eng._team_size, name=f"planted_chunk[{plant.__name__}]")
        bind_d, bind_c = paged_binds(eng._decode_exe, exe, eng.params, eng._pages,
                                     rows=eng.capacity, n_pt=eng.n_pt, chunk_len=eng.chunk,
                                     device=eng.device)
        rep = paged_pair_report(eng._decode_exe, exe, bind_d, bind_c,
                                pytree.tree_leaves(eng._pages), "planted")
        xww = [f for f in rep.errors if f.rule_id == "H-XWW"]
        try:
            rep.raise_if_errors()
            fail(f"planted {plant.__name__}: strict did not refuse a chunk graph that writes "
                 "a page pool")
        except GraphValidationError as e:
            refused = str(e)
        if not xww or "C-RO" in rep.by_rule():
            fail(f"planted {plant.__name__}: the pool write was not reported as H-XWW "
                 f"({rep.by_rule()})")
        secs = time.perf_counter() - t0
        log(f"planted {plant.__name__}: chunk graph writing {xww[0].node!r} caught: "
            f"{len(xww)} H-XWW; strict refused ({refused[:160]}) in {secs:.1f}s")
        res[plant.__name__] = {"h_xww": len(xww), "refused": refused, "s": secs}
    return res


def affinity_probe(topo) -> str | None:
    """Whether this host's OS lets a thread pin itself: None when
    ``sched_setaffinity`` on a fresh thread took (read back equal), else
    the OS error."""
    import os
    import threading

    from repro_torch.hwperf import affinity_supported, disjoint_core_sets

    if not affinity_supported():
        return "no sched_setaffinity on this platform"
    want = set(disjoint_core_sets(topo, 2)[0])
    out: dict = {}

    def pin() -> None:
        try:
            os.sched_setaffinity(0, want)
            got = os.sched_getaffinity(0)
            out["err"] = None if got == want else f"asked {sorted(want)}, got {sorted(got)}"
        except OSError as e:
            out["err"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=pin)
    t.start()
    t.join()
    return out["err"]


def check_pinning(rt, probe_err, caught, what: str) -> dict:
    """Pinning is applied or the OS refused, never a silent pass.  Accepted:
    every executor thread's affinity equals its planned set.  Refused: the
    reference's contract — one warning, the pool rolled back to the usable
    CPUs, unpinned."""
    import os

    applied = rt.pinning_applied
    tids = rt.pool.executor_thread_ids()
    masks = [sorted(os.sched_getaffinity(t)) for t in tids if t is not None]
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if applied is None:
        fail(f"{what}: pinning='on' left no record of what happened")
    if probe_err is None:
        if not applied.pinned or len(masks) != len(tids):
            fail(f"{what}: the OS accepts sched_setaffinity but the pool is {applied.describe()}")
        for ex, mask in enumerate(masks):
            if mask != sorted(applied.plan.cpus_for(ex)):
                fail(f"{what}: executor {ex} runs on {mask}, planned "
                     f"{sorted(applied.plan.cpus_for(ex))}")
    else:
        full = sorted(c.cpu for c in applied.plan.topology.cpus)
        if applied.pinned or len(warned) != 1 or any(m != full for m in masks):
            fail(f"{what}: the OS refused pinning ({probe_err}) but the pool is "
                 f"{applied.describe()} with masks {masks} and {len(warned)} warnings")
        log(f"{what}: OS refused sched_setaffinity: {probe_err}")
    log(f"{what}: {applied.describe()} {applied.plan.describe()}; thread masks {masks}")
    return {"pinned": applied.pinned, "plan": [list(a) for a in applied.plan.assignments],
            "masks": masks, "errors": list(applied.errors), "os_error": probe_err,
            "warnings": warned}


def contention_decode(torch, cfg, params, rt) -> dict:
    """gemma-2b's decode step compiled under ``cpf-contention`` (the policy
    the runtime installed from its measured model) and under CPF, each as a
    static plan on the runtime's streams: 8 greedy steps from one eager
    prefill of 4 x 64 tokens, the same tokens; the launch counts set to 0
    just before and read just after."""
    import numpy as np

    import repro_torch
    from repro_torch.models import transformer
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    B, P, steps = 4, 64, 8
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)).cuda()
    cache0 = transformer.init_cache(cfg, B, P + steps + 1, device="cuda")
    tok_spec = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    exes, compile_s = {}, {}
    for policy in ("cpf", "cpf-contention"):
        t0 = time.perf_counter()
        exes[policy] = repro_torch.compile(
            make_decode_step(cfg), params, cache0, tok_spec, hw=rt.hw, runtime=rt,
            policy=policy, backend="host", jit_nodes=True, host_mode="static",
            n_executors=rt.n_workers, team_size=1, schedule_search="off",
            name=f"hwperf_decode[{policy}]")
        exes[policy].host_plan(rt.n_workers)
        compile_s[policy] = time.perf_counter() - t0
        if exes[policy].schedule.policy != policy:
            fail(f"hwperf: decode compiled under {exes[policy].schedule.policy}, not {policy}")
    a, b = (exes[p].schedule.placements for p in ("cpf", "cpf-contention"))
    moved = sum(a[n][0] != b[n][0] for n in a)
    reset_launch_counts()
    logits, cache = make_prefill_step(cfg)(params, cache0, {"tokens": toks})
    streams, last = {}, {}
    for policy, exe in exes.items():
        tok, c, out = logits.argmax(-1, keepdim=True).to(torch.int32), cache, []
        for _ in range(steps):
            lg, c = exe(params, c, tok)
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok[:, 0].tolist())
        streams[policy], last[policy] = out, lg
    torch.cuda.synchronize()
    launches = launch_counts()
    if streams["cpf"] != streams["cpf-contention"]:
        fail(f"hwperf: cpf-contention decode tokens {streams['cpf-contention']} differ from "
             f"CPF's {streams['cpf']}")
    if launches["decode_attention"] != 2 * steps * cfg.n_layers:
        fail(f"hwperf: B2 launched {launches['decode_attention']} times, not "
             f"{2 * steps * cfg.n_layers} (2 policies x {steps} steps x {cfg.n_layers} layers)")
    diff = float((last["cpf"].float() - last["cpf-contention"].float()).abs().max())
    log(f"hwperf: cpf-contention decode = CPF decode, {steps} greedy steps x {B} rows "
        f"(last logits max diff {diff:.3e}); {moved} of {len(a)} nodes on another executor; "
        f"compile s {json.dumps(compile_s)}; launches {json.dumps(launches)}")
    return {"tokens": streams["cpf"], "moved_nodes": moved, "nodes": len(a),
            "last_logits_max_diff": diff, "compile_s": compile_s, "launches": launches}


def serve_cli_run(torch, probe_err) -> dict:
    """``python -m repro_torch.launch.serve --arch gemma-2b --paged --check
    strict --pinning on`` at full width: 4 requests of 64 and 200 tokens, 8
    new each.  It must verify clean, serve, and pin (or report the OS's
    refusal in its one warning)."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--paged",
           "--check", "strict", "--pinning", "on", "--requests", "4", "--prompt-len", "64,200",
           "--max-new", "8"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    secs = time.perf_counter() - t0
    out = res.stdout
    if res.returncode != 0:
        fail(f"serve CLI exited {res.returncode}: {out[-2000:]} {res.stderr[-3000:]}")
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("paged engine", "check[", "pinning:", "[paged]"))]
    for ln in lines:
        log(f"serve CLI: {ln}")
    if "check[strict]: 0 error(s)" not in out or "[paged] served 4 requests, 32 tokens" not in out:
        fail(f"serve CLI: no clean check or no complete serve: {out[-2000:]}")
    if probe_err is None and "pinning: AppliedPinning(pinned" not in out:
        fail(f"serve CLI: the OS accepts pinning but the CLI did not pin: {out[-2000:]}")
    if probe_err is not None and ("AppliedPinning(unpinned" not in out
                                  or "rejected by the OS" not in res.stderr):
        fail(f"serve CLI: the OS refused pinning but the CLI did not say so: {res.stderr[-2000:]}")
    log(f"serve CLI: exit 0 in {secs:.1f}s")
    return {"s": secs, "lines": lines}


INTERFERENCE_TURNS = ("graph", "eager", "graph", "eager")


def interference_turns(torch, hwperf, topo) -> dict:
    """The interference matrix measured in turns, twice with each launch
    mode: ``graph`` (each window one CUDA graph launch: the card's
    contention alone) and ``eager`` (one Python call a kernel, the host's
    feed and its contention included).  Prints each run, the spread of
    every entry over a mode's runs, and returns the graph runs' mean
    matrix, which the runtime adopts as its contention model."""
    runs: list[dict] = []
    mats: dict[str, list] = {"graph": [], "eager": []}
    t_all = time.perf_counter()
    for i, launch in enumerate(INTERFERENCE_TURNS):
        t0 = time.perf_counter()
        m = hwperf.measure_interference(topology=topo, device="cuda", launch=launch)
        secs = time.perf_counter() - t0
        cls = m.classes()
        log(f"hwperf: interference run {i + 1} ({launch}) on {m.device} (pinned={m.pinned}, "
            f"disjoint={m.disjoint}) in {secs:.1f}s; solo us/iter "
            + " ".join(f"{c}={1e6 * m.solo[c]:.2f}" for c in cls)
            + "; host us/iter to enqueue "
            + " ".join(f"{c}={1e6 * m.solo_host[c]:.2f}" for c in cls))
        log(f"hwperf: run {i + 1} ({launch}) slowdown (row beside column): " + "; ".join(
            f"{a}: " + " ".join(f"{b}={m.slowdown(a, b):.3f}" for b in cls) for a in cls))
        mats[launch].append(m)
        runs.append({"launch": launch, "s": secs, "pinned": m.pinned, "disjoint": m.disjoint,
                     "device": m.device, "solo_s": m.solo, "solo_host_s": m.solo_host,
                     "pair_s": {f"{a}|{b}": v for (a, b), v in m.pair.items()},
                     "slowdown": {f"{a}|{b}": m.slowdown(a, b) for a in cls for b in cls}})
    spread: dict[str, dict] = {}
    for launch, ms in mats.items():
        cls = ms[0].classes()
        entry = {f"solo {c}": [1e6 * m.solo[c] for m in ms] for c in cls}
        entry.update({f"{a}|{b}": [m.slowdown(a, b) for m in ms] for a in cls for b in cls})
        spread[launch] = {k: max(v) - min(v) for k, v in entry.items()}
        log(f"hwperf: {launch} spread over {len(ms)} runs (max - min): " + " ".join(
            f"{k}={v:.3f}" for k, v in spread[launch].items()))
    graph = mats["graph"]
    mean = hwperf.InterferenceMatrix(
        solo={c: sum(m.solo[c] for m in graph) / len(graph) for c in graph[0].solo},
        pair={k: sum(m.pair[k] for m in graph) / len(graph) for k in graph[0].pair},
        pinned=all(m.pinned for m in graph), disjoint=graph[0].disjoint,
        device=graph[0].device, launch="graph")
    return {"runs": runs, "spread": spread, "graph_matrix": mean,
            "s": time.perf_counter() - t_all}


def hwperf_phase(torch, cfg, params) -> dict:
    """The hwperf layer on the card host: its topology and whether its OS
    pins threads; the interference matrix of the three classes on the card
    in turns (``interference_turns``); a fresh runtime with
    ``pinning="on"`` adopts the graph runs' matrix as its contention model, and
    gemma-2b's decode step runs under ``cpf-contention`` and CPF for the
    same tokens; then the serving CLI once, ``--paged --check strict
    --pinning on``, at full width."""
    import warnings

    from repro_torch import hwperf
    from repro_torch.runtime import Runtime

    topo = hwperf.detect_topology()
    log(f"hwperf: card host {topo.describe()}; cores {topo.physical_cores()}")
    probe_err = affinity_probe(topo)
    log(f"hwperf: sched_setaffinity on this host: "
        f"{'accepted' if probe_err is None else 'refused'}")
    turns = interference_turns(torch, hwperf, topo)
    model = hwperf.ContentionModel.from_matrix(turns["graph_matrix"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt = Runtime(device="cuda", pinning="on")
        rt.set_contention_model(model)
        rt.pool
    pin = check_pinning(rt, probe_err, caught, "hwperf")
    if rt.calibration.get_interference() != model.to_dict():
        fail("hwperf: the calibration store did not keep the contention model")
    log(f"hwperf: hot classes {sorted(model.hot_classes())}; {rt.describe()}")
    decode = contention_decode(torch, cfg, params, rt)
    rt.close()
    cli = serve_cli_run(torch, probe_err)
    return {"topology": topo.describe(), "os_affinity_error": probe_err,
            "interference": turns["runs"], "spread": turns["spread"],
            "interference_s": turns["s"], "hot": sorted(model.hot_classes()),
            "pinning": pin, "decode": decode, "launches": decode["launches"], "cli": cli}


# -- the serving fleet ----------------------------------------------------------

FLEET_NEW = 16                  # new tokens a request
# gemma-2b at full width with an untied output head: with the tied
# embedding, random weights make every stream repeat its prompt's last token
# (the serve phases' first tokens), so no replay fault could show in a stream
FLEET_OVERRIDES = {"tie_embeddings": False}
FLEET_TIMING = {"heartbeat_s": 0.5, "liveness_s": 120.0, "startup_grace_s": 600.0}


def fleet_prompts(vocab: int) -> list:
    """4 x 200 and 4 x 333 prompt tokens; requests 0 and 1 share their first
    16 tokens (the router's affinity length)."""
    import numpy as np

    rng = np.random.default_rng(8)
    prompts = [[int(x) for x in rng.integers(1, vocab, n)] for n in (200,) * 4 + (333,) * 4]
    prompts[1][:16] = prompts[0][:16]
    return prompts


def fleet_run(fleet, prompts, what: str, vocab: int, injector=None) -> dict:
    """Serve ``prompts`` through ``fleet`` (16 new tokens each) and check
    that every request came back whole and in the vocabulary."""
    t0 = time.perf_counter()
    done = fleet.run([(p, FLEET_NEW) for p in prompts], injector=injector, timeout_s=600)
    wall = time.perf_counter() - t0
    if len(done) != len(prompts) or any(
            not r.done or len(r.tokens) != FLEET_NEW for r in done):
        fail(f"fleet {what}: {len(done)} requests came back, not {len(prompts)} whole ones")
    if any(not (0 <= t < vocab) for r in done for t in r.tokens):
        fail(f"fleet {what}: a token id outside the vocabulary")
    n_tok = sum(len(r.tokens) for r in done)
    log(f"fleet {what}: {len(done)} requests, {n_tok} tokens in {wall:.2f}s = "
        f"{n_tok / wall:.1f} tok/s; replicas {sorted({r.worker for r in done})}")
    return {"done": done, "wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall}


def fleet_cli_start(store_dir: str) -> dict:
    """Start ``python -m repro_torch.launch.serve --arch gemma-2b --smoke
    --replicas 2 --paged`` and the same with ``--continuous`` on the card,
    both at once (each a parent and two replicas, a calibration store
    each)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    return {mode: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--smoke",
         "--replicas", "2", mode, "--calibration-store",
         os.path.join(store_dir, f"cli{mode}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for mode in ("--paged", "--continuous")}


def fleet_cli_finish(procs: dict, t0: float) -> dict:
    """Wait for the CLI runs of ``fleet_cli_start``: each must exit 0 and
    serve every request with no failover."""
    res = {}
    for mode, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"fleet CLI {mode}: no exit in 600 s")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"fleet CLI {mode}: exited {proc.returncode}: {out[-2000:]} {err[-3000:]}")
        lines = [ln.strip() for ln in out.splitlines()
                 if ln.startswith(("[fleet:", "  failovers="))]
        for ln in lines:
            log(f"fleet CLI {mode}: {ln}")
        if f"[fleet:{mode.lstrip('-')} x2] served 8 requests, 256 tokens" not in out or \
                "failovers=0 requeued=0" not in out:
            fail(f"fleet CLI {mode}: no complete serve: {out[-2000:]}")
        log(f"fleet CLI {mode}: exit 0, {secs:.1f}s after both started")
        res[mode] = {"s": secs, "lines": lines}
    return res


def fleet_phase(torch) -> dict:
    """The serving fleet on the card (``repro_torch.fleet``): two replicas,
    each a spawned process holding full-width gemma-2b (bf16, random weights
    from seed 0, untied head: ``FLEET_OVERRIDES``) in a ``ContinuousEngine``
    of 4 slots, one calibration store, the CLI's real-engine timings.  Run A
    serves 8 requests; run B the same with a SIGKILL after 24 tokens (zero
    loss, one failover, one respawn; every stream not failed over equal to
    run A's bit for bit; the replayed ones counted); then 4 of run A's
    prompts, at least one on the respawned replica, equal to run A's, while
    the serving CLI runs with ``--smoke --replicas 2``, paged and continuous
    at once.  The card's free memory drops by the two replicas' weights and
    comes back after ``close()`` and the CLI runs.  The kernels run in the replicas, whose
    launch counts this process cannot see."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.fleet import FaultInjector, FaultSpec, Fleet, FleetConfig

    cfg = get_config("gemma-2b").reduced(**FLEET_OVERRIDES)
    weight_bytes = 2 * cfg.n_params()
    prompts = fleet_prompts(cfg.vocab_size)
    res: dict = {"weight_gb": weight_bytes / 1e9}
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"kind": "continuous", "arch": "gemma-2b", "smoke": False, "max_batch": 4,
                "max_len": max(len(p) for p in prompts) + FLEET_NEW + 1,
                "calibration_store": os.path.join(tmp, "calibration.json"),
                "device": "cuda", "overrides": FLEET_OVERRIDES}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        fleet = Fleet(FleetConfig(n_workers=2, engine=spec, max_inflight_per_worker=4,
                                  **FLEET_TIMING))
        cli: dict = {}
        try:
            fleet.wait_ready()
            res["boot_s"] = time.perf_counter() - t0
            free_up = torch.cuda.mem_get_info()[0]
            res["replicas_gb"] = (free0 - free_up) / 1e9
            log(f"fleet: 2 replicas of gemma-2b ({weight_bytes / 1e9:.2f} GB of bf16 weights "
                f"each) ready in {res['boot_s']:.1f}s; the card's free memory "
                f"{free0 / 1e9:.2f} -> {free_up / 1e9:.2f} GB")
            if free0 - free_up < 2 * weight_bytes:
                fail(f"fleet: free memory fell by {(free0 - free_up) / 1e9:.2f} GB, less than "
                     f"two replicas' weights ({2 * weight_bytes / 1e9:.2f} GB)")
            run_a = fleet_run(fleet, prompts, "run A", cfg.vocab_size)
            if fleet.stats()["n_failovers"]:
                fail(f"fleet run A: a replica failed with no fault: {fleet.events}")
            a_streams = [list(r.tokens) for r in run_a["done"]]

            token_t: list = []
            fleet.on_token = lambda rid, tok, idx: token_t.append(
                (time.monotonic() - fleet._t0, rid))
            inj = FaultInjector([FaultSpec("kill", at_tokens=24)], seed=0)
            run_b = fleet_run(fleet, prompts, "run B (kill at 24 tokens)", cfg.vocab_size,
                              injector=inj)
            st = fleet.stats()
            if not (st["n_failovers"] == 1 and st["n_requeued"] >= 1 and st["n_restarts"] == 1):
                fail(f"fleet run B: {st}, not one failover, one restart and a requeue")
            victim = inj.log[0][1]
            fail_t = next(t for t, kind, _, _ in fleet.events if kind == "fail")
            replayed = {r.rid for r in run_b["done"] if r.n_requeues}
            first_replayed = min(t for t, rid in token_t if rid in replayed and t >= fail_t)
            res["fail_to_replayed_token_s"] = first_replayed - fail_t
            equal, differ = 0, {}
            for i, r in enumerate(run_b["done"]):
                if r.n_requeues:
                    if list(r.tokens) == a_streams[i]:
                        equal += 1
                    else:
                        differ[i] = next(j for j, (x, y) in enumerate(zip(r.tokens, a_streams[i]))
                                         if x != y)
                elif list(r.tokens) != a_streams[i]:
                    fail(f"fleet run B: request {i} was not failed over and its stream "
                         f"differs from run A's: {r.tokens} vs {a_streams[i]}")
            res.update(victim=victim, log=inj.log, n_replayed=len(replayed),
                       replayed_equal=equal, replayed_first_diff=differ, stats=st)
            log(f"fleet run B: killed replica {victim} ({inj.log}); {st}; first replayed "
                f"token {res['fail_to_replayed_token_s']:.2f}s after the fail event; "
                f"replayed streams equal to run A's: {equal} of {len(replayed)}; first "
                f"differing index of the others {differ}; the {8 - len(replayed)} others "
                f"equal bit for bit")

            # the CLI runs boot while the respawn does and run C serves (no
            # number of run C is gated); the memory check waits for them
            t_cli = time.perf_counter()
            cli = fleet_cli_start(tmp)
            fleet.wait_ready()
            run_c = fleet_run(fleet, [prompts[i] for i in (0, 2, 4, 6)],
                              "run C (after the respawn)", cfg.vocab_size)
            if fleet.stats()["generations"][victim] != 1 or \
                    not any(r.worker == victim for r in run_c["done"]):
                fail(f"fleet run C: no request went to the respawned replica {victim}")
            for r, i in zip(run_c["done"], (0, 2, 4, 6)):
                if list(r.tokens) != a_streams[i]:
                    fail(f"fleet run C: request {i} on replica {r.worker} differs from run "
                         f"A's: {r.tokens} vs {a_streams[i]}")
            res["boots"] = list(fleet.boots)
            for b in fleet.boots:
                log(f"fleet: boot of replica {b['wid']} generation {b['generation']}: "
                    f"{b['boot_s']:.1f}s to ready; set-up s {json.dumps(b['setup_s'])}")
        except BaseException:             # a failed check: stop the CLI runs too
            for proc in cli.values():
                proc.kill()
            raise
        finally:
            fleet.close()
        res["cli"] = fleet_cli_finish(cli, t_cli)
        deadline = time.perf_counter() + 30
        while True:         # a killed replica's memory returns once it is reaped
            free_end = torch.cuda.mem_get_info()[0]
            if free_end >= free0 - 2**30 or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
        res["free_gb"] = {"before": free0 / 1e9, "up": free_up / 1e9, "after": free_end / 1e9}
        log(f"fleet: free memory after close() {free_end / 1e9:.2f} GB (before boot "
            f"{free0 / 1e9:.2f})")
        if free_end < free0 - 2**30:
            fail("fleet: the card's memory did not come back within 1 GiB after close()")
        res["runs"] = {k: {"wall_s": r["wall_s"], "tokens": r["tokens"],
                           "tok_per_s": r["tok_per_s"],
                           "streams": [list(q.tokens) for q in r["done"]]}
                       for k, r in (("A", run_a), ("B", run_b), ("C", run_c))}
        log(f"fleet: run A {run_a['tok_per_s']:.1f} tok/s in {run_a['wall_s']:.2f}s (each "
            f"replica's prefill captures inside), run B {run_b['tok_per_s']:.1f} tok/s in "
            f"{run_b['wall_s']:.2f}s (the failover and replay inside), run C "
            f"{run_c['tok_per_s']:.1f} tok/s in {run_c['wall_s']:.2f}s (beside the CLI runs)")
    return res


# ---------------------------------------------------------------------------
# the dist phase: the distribution layer (repro_torch.dist), the dry-run's
# rank shares and the "mesh" backend on the one card
# ---------------------------------------------------------------------------

DIST_STEPS = 2                  # sharded world-1 steps held to the train phase's first two
DIST_TOL = 1e-5                 # relative; 0 expected (the same kernels on the same tensors)
# rank 0's share of the single-pod mesh (32 x 8): (arch, shape), whole; each
# cell's time is mostly the host's DTensor dispatch, in the fake trace and
# in the two runs (at 4 layers on an H100 80GB HBM3 at 700 W: 4.6 / 4.7 /
# 3.7 s a cell)
DIST_CELLS = (("gemma-2b", "train_4k"), ("olmoe-1b-7b", "train_4k"),
              ("gemma-2b", "decode_32k"))
# B2's log-sum-exp form at gemma-2b's decode_32k rank share: 4 rows, a
# 4096-entry cache shard, 8 / 1 heads of 256; per row, one row idle
DIST_LSE = {"B": 4, "Hq": 8, "Hkv": 1, "hd": 256, "C": 4096}
DIST_LSE_LENGTHS = (4096, 1500, 37, 0)


def lse_case(torch, form: str, dtype):
    """Inputs for B2's log-sum-exp form at ``DIST_LSE``: shared (every entry
    live, the step at the last one) or per row (``DIST_LSE_LENGTHS``, the
    last row keeping nothing)."""
    B, Hq, Hkv, hd, C = (DIST_LSE[k] for k in ("B", "Hq", "Hkv", "hd", "C"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, C, Hkv, hd), generator=gen, device="cuda").to(dtype)
    if form == "shared":
        kv_pos = torch.arange(C, dtype=torch.int32, device="cuda")
        q_pos = torch.tensor(C - 1, dtype=torch.int32, device="cuda")
    else:
        kv_pos = torch.full((B, C), -1, dtype=torch.int32)
        for b, n in enumerate(DIST_LSE_LENGTHS):
            kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
        q_pos = torch.tensor([max(n - 1, 0) for n in DIST_LSE_LENGTHS], dtype=torch.int32)
        kv_pos, q_pos = kv_pos.cuda(), q_pos.cuda()
    return q, k, v, kv_pos, q_pos


def lse_kernel_rows(torch) -> dict:
    """(d) B2's log-sum-exp form against its plain version, every row
    (the idle one: its output the mean of V, its lse -inf in both), shared
    and per row, in bf16 (timed, beside SDPA) and f32."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_KERNEL_TOL
        for form in ("shared", "per_row"):
            q, k, v, kv_pos, q_pos = lse_case(torch, form, dtype)
            out, lse = decode_attention_cuda(q, k, v, kv_pos, q_pos, None, lse=True)
            ref, ref_lse = decode_attention_plain(q, k, v, kv_pos, q_pos, None, lse=True)
            what = f"B2 lse form ({form}, {str(dtype).split('.')[-1]})"
            err = check_kernel(torch, what, out, ref, tol=tol)
            idle = torch.isneginf(ref_lse)
            if not torch.equal(idle, torch.isneginf(lse)):
                fail(f"{what}: rows keeping nothing differ: {idle.tolist()} vs "
                     f"{torch.isneginf(lse).tolist()}")
            lse_err = float((lse[~idle] - ref_lse[~idle]).abs().max()) if (~idle).any() else 0.0
            # a log-sum-exp of scores the two paths round alike in f32 and at
            # other places in bf16 (the plain version's scores are bf16)
            if not lse_err <= tol * 4:
                fail(f"{what}: lse max abs err {lse_err} > {tol * 4}")
            row = {"form": "lse", "max_abs_err": max(err, lse_err), "lse_max_abs_err": lse_err,
                   "idle_rows": int(idle[:, 0].sum())}
            if dtype == torch.bfloat16 and form == "shared":
                g = DIST_LSE["Hq"] // DIST_LSE["Hkv"]
                kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
                vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
                t = timings(torch,
                            lambda: decode_attention_cuda(q, k, v, kv_pos, q_pos, None, lse=True),
                            lambda: decode_attention_plain(q, k, v, kv_pos, q_pos, None, lse=True),
                            lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt), 100)
                bound_ms, bound_by = dense_bound_ms(q, k, kv_pos, q_pos, None)
                row.update({**t, "bound_ms": bound_ms, "bound_by": bound_by})
            rows[f"lse,decode_32k,{form},{str(dtype).split('.')[-1]}"] = row
    log("dist: B2 lse form " + json.dumps({k: round(r["max_abs_err"], 6) for k, r in rows.items()})
        + f"; {rows['lse,decode_32k,shared,bfloat16']['ms']:.4f} ms vs plain "
        f"{rows['lse,decode_32k,shared,bfloat16']['plain_ms']:.4f}")
    return rows


def dist_world1_steps(torch, train: dict) -> dict:
    """(a) A real NCCL group of world 1 and a 1x1 ("data", "model") mesh:
    full-width gemma-2b, the train phase's state (seed 0, its AdamW) and
    batches, DIST_STEPS steps through the sharded path (DTensor state placed
    by ``state_pspecs``, ``make_sharded_train_step``); losses and gradient
    norms held to the train phase's unsharded steps, B3's and the AdamW
    kernels' launches per step as the train phase counts them."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.dist.sharding import Mesh, state_pspecs
    from repro_torch.dist.train import distribute_tree, init_group, make_sharded_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, init_train_state

    t0 = time.perf_counter()
    init_group("cuda")
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        fail(f"dist: world {dist.get_world_size()} on {dist.get_backend()}, not 1 on nccl")
    cfg = get_config("gemma-2b")
    B, S, L = TRAIN_B, TRAIN_S, cfg.n_layers
    tcfg = TrainStepConfig(remat=True, adamw=AdamWConfig(lr=1e-4), warmup_steps=1,
                           total_steps=TRAIN_STEPS)
    mesh = Mesh((1, 1), ("data", "model"))
    dm = mesh.to_device_mesh("cuda")
    state = init_train_state(cfg, 0, tcfg.adamw, device="cuda")
    state = distribute_tree(state, state_pspecs(cfg, state, mesh), mesh, dm)
    step = make_sharded_train_step(cfg, tcfg, mesh, dm, global_batch=B)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      kind="bigram"))
    losses, norms, per_step, times = [], [], [], []
    for i in range(DIST_STEPS):
        before = launch_counts()
        t1 = time.perf_counter()
        state, m = step(state, data.batch(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in
                         ("flash_attention_train", "flash_attention_train.mma",
                          "flash_attention_bwd", "flash_attention_bwd.mma", "adamw")})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    n_leaves = len(pytree.tree_leaves(state["params"]))
    for i, c in enumerate(per_step):
        if c != {"flash_attention_train": 2 * L, "flash_attention_train.mma": 2 * L,
                 "flash_attention_bwd": L, "flash_attention_bwd.mma": L,
                 "adamw": adamw_launches(n_leaves)}:
            fail(f"dist world-1 step {i}: launches {c}, not {2 * L} B3 training forwards and "
                 f"{L} backwards, all mma, and {adamw_launches(n_leaves)} AdamW kernels (the "
                 f"DTensor leaves' local shards)")
    want_l, want_n = train["losses"][:DIST_STEPS], train["grad_norms"][:DIST_STEPS]
    exact = losses == want_l and norms == want_n
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(losses + norms, want_l + want_n))
    if not rel <= DIST_TOL:
        fail(f"dist world-1: losses {losses} / grad norms {norms} vs the unsharded "
             f"{want_l} / {want_n} (rel {rel:.3g} > {DIST_TOL})")
    log(f"dist: world 1 on nccl, mesh 1x1: {DIST_STEPS} sharded gemma-2b steps, losses "
        f"{losses}, grad norms {norms}: {'bit-equal to' if exact else f'rel {rel:.3g} from'} "
        f"the unsharded steps; B3 per step {per_step[0]}; s/step "
        f"{[round(t, 2) for t in times]}")
    launches = {k: sum(c[k] for c in per_step)
                for k in ("flash_attention_train", "flash_attention_bwd", "adamw")}
    del state
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "bit_equal": exact, "max_rel": rel,
            "launches_per_step": per_step, "launches": launches, "step_s": times,
            "seconds": time.perf_counter() - t0}


def dist_rank_shares(torch) -> dict:
    """(b) Rank 0's share of the single-pod mesh (32 x 8) under the fake
    process group, each DIST_CELLS cell traced (the walker's per-rank
    flops / bytes / collective bytes, the roofline) and run once at full
    width (measured peak under the card's memory, device ms beside the
    roofline bound, kernel launches by kind).  Each group and model is
    freed before the next."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    out, failed = {}, []
    for arch, shape in DIST_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh, want_graphi=False, run=True, device="cuda")
        tag = f"{arch}.{shape}"
        torch.cuda.empty_cache()
        if rec["status"] != "ok":
            log(f"dist {tag}: {rec.get('error')}\n{rec.get('traceback', '')}")
            failed.append(tag)
            continue
        run = rec["run"]
        if not run["fits_hbm_measured"] or run["run_peak_bytes"] >= run["card_bytes"]:
            fail(f"dist {tag}: peak {run['run_peak_bytes'] / 1e9:.2f} GB over the card's "
                 f"{run['card_bytes'] / 1e9:.2f} GB")
        want = (("decode_attention.lse",) if rec["kind"] == "decode" else
                ("flash_attention_train", "flash_attention_bwd")
                + (("moe_gmm", "moe_gmm_bwd") if "olmoe" in arch else ()))
        missing = [k for k in want if run["launches"].get(k, 0) <= 0]
        if missing:
            fail(f"dist {tag}: {missing} not launched ({run['launches']})")
        rf = rec["roofline"]
        log(f"dist: {tag} rank 0 of {rec['mesh']}: "
            f"traced peak {rec['bytes_per_device'] / 1e9:.2f} GB, run peak "
            f"{run['run_peak_bytes'] / 1e9:.2f} GB of {run['card_bytes'] / 1e9:.2f}; "
            f"{run['device_ms']:.2f} ms vs roofline {rf['bound_s'] * 1e3:.3f} ms "
            f"({rf['dominant']}: c {rf['compute_s'] * 1e3:.3f} m {rf['memory_s'] * 1e3:.3f} "
            f"x {rf['collective_s'] * 1e3:.3f}); flops {rf['flops']:.4g} bytes "
            f"{rf['bytes']:.4g} collective {rf['collective_bytes']:.4g}; launches "
            f"{json.dumps(run['launches'])}; trace {rec['trace_s']}s")
        out[tag] = rec
    if failed:
        fail(f"dist: rank shares {failed} failed")
    return out


def lstm_fn_graph(torch, L: int, T: int, B: int, H: int):
    """The paper's L x T LSTM recurrence graph (``core.wavefront``'s
    ``recurrence_graph``) with each cell a node on the card: gates from the
    layer below (the input x_t at layer 0) and the step before, B4 for the
    state update; a node's value is its (h, c)."""
    from dataclasses import replace

    from repro_torch.core.graph import Graph
    from repro_torch.core.wavefront import recurrence_graph

    gen = torch.Generator(device="cuda").manual_seed(13)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    xs = [rnd(B, H) for _ in range(T)]
    wx = [rnd(H, 4 * H, scale=H ** -0.5) for _ in range(L)]
    wh = [rnd(H, 4 * H, scale=H ** -0.5) for _ in range(L)]
    bias = [rnd(4 * H, scale=0.1) for _ in range(L)]
    zero = torch.zeros((B, H), device="cuda")
    skel = recurrence_graph(L, T)
    g = Graph(skel.name)
    for node in skel.nodes:
        l, t = node.meta["layer"], node.meta["step"]

        def cell(*deps, l=l, t=t):
            below = deps[0][0] if l > 0 else xs[t]
            h, c = deps[-1] if t > 0 else (zero, zero)
            return torch.ops.repro_torch.lstm_cell(below @ wx[l], h @ wh[l], bias[l], c)

        g.add(replace(node, fn=cell, flops=2.0 * 2 * B * H * 4 * H))
    return g


def dist_mesh_backend(torch) -> dict:
    """(c) The "mesh" backend (the frozen schedule's barrier slots bound to
    executor sub-meshes of a 2 x 4 mesh description, run slot by slot) on
    the LSTM recurrence graph, against the host backend: every cell's h and
    c bit-equal."""
    import repro_torch
    from repro_torch.core.cost_model import H100
    from repro_torch.dist.sharding import Mesh

    g = lstm_fn_graph(torch, 4, 16, 16, 256)
    mesh = Mesh((2, 4), ("data", "model"))
    t0 = time.perf_counter()
    rt = repro_torch.Runtime(device="cuda")
    mexe = repro_torch.compile(g, hw=H100, backend="mesh", mesh=mesh, n_executors=4,
                               team_size=1, runtime=rt)
    hexe = repro_torch.compile(g, hw=H100, backend="host", n_executors=4, team_size=1,
                               runtime=rt)
    got, want = mexe({}), hexe({})
    torch.cuda.synchronize()
    rt.close()
    plan = mexe.last_plan
    bad = [n for n in want if not all(bit_equal(torch, a, b) for a, b in zip(got[n], want[n]))]
    if bad or set(got) != set(want):
        fail(f"dist mesh backend: {len(bad)} of {len(want)} cells differ from the host "
             f"backend's (first {bad[:3]})")
    lanes = max(len(s) for s in plan.slots)
    log(f"dist: mesh backend on the {len(g)}-cell LSTM graph: {len(plan.slots)} slots, up to "
        f"{lanes} lanes on {plan.n_executors} sub-meshes of {mesh}; every cell bit-equal to "
        f"the host backend ({time.perf_counter() - t0:.1f}s)")
    return {"cells": len(g), "slots": len(plan.slots), "max_lanes": lanes,
            "executors": plan.n_executors, "bit_equal": True}


def dist_phase(torch, train: dict) -> dict:
    """The distribution layer on the one card: (d) B2's log-sum-exp form,
    (a) the world-1 NCCL steps against the train phase's, (c) the "mesh"
    backend against the host backend, and (b) the rank shares of the
    production mesh."""
    out = {"lse_rows": lse_kernel_rows(torch)}
    out["world1"] = dist_world1_steps(torch, train)
    out["mesh_backend"] = dist_mesh_backend(torch)
    out["cells"] = dist_rank_shares(torch)
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
    # recurrentgemma-2b, falcon-mamba-7b (its depth cut) and h2o-danube3-4b,
    # each freed before the next is built and before the serve phases
    train = timed("train", train_phase, torch)
    family_train = {tag: timed(tag, family_train_phase, torch, arch, tag, layers)
                    for arch, tag, layers in FAMILY_TRAIN}
    # the frontend archs: whisper-medium whole, llava-next-34b (its depth
    # cut), each with its embeddings in every batch
    family_train.update({tag: timed(tag, family_train_phase, torch, arch, tag, layers, S)
                         for arch, tag, layers, S in FRONTEND_TRAIN})
    # phase 7: serve full-width gemma-2b through the three engines
    t1 = time.perf_counter()
    cfg, params = build_model(torch, args.layers)
    serve = {"paged": paged_serve_phase(torch, cfg, params),
             "slot": slot_serve_phase(torch, cfg, params),
             "wave": wave_serve_phase(torch, cfg, params)}
    phase_s["serve"] = time.perf_counter() - t1
    # the hwperf layer: the card host's topology and pinning, the card's
    # interference matrix, cpf-contention decode of the same gemma-2b, and
    # the serving CLI with --check strict --pinning on
    hw = timed("hwperf", hwperf_phase, torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    # the serving fleet: two full-width gemma-2b replicas in spawned
    # processes (the card holds no model of this process), a SIGKILL
    # mid-decode, the respawn; the CLI's --replicas 2, paged and continuous
    fleet = timed("fleet", fleet_phase, torch)
    # phase 8: serve full-width granite-moe-1b-a400m through the three engines
    t1 = time.perf_counter()
    moe_cfg, moe_params = build_moe_model(torch)
    moe = moe_serve_phase(torch, moe_cfg, moe_params)
    phase_s["moe_serve"] = time.perf_counter() - t1
    # phase 9: serve falcon-mamba-7b (FALCON_SERVE_LAYERS of its layers) and
    # recurrentgemma-2b at full width through the slot and wave engines (each
    # model freed before the next is built)
    del moe_params
    torch.cuda.empty_cache()
    recurrent = {tag: timed(f"{tag}_serve", recurrent_serve_phase, torch, arch, tag, layers)
                 for arch, tag, layers in RECURRENT}
    # phase 10: serve yi-9b, h2o-danube3-4b and command-r-plus-104b (its
    # depth cut) at full width, each freed before the next is built
    zoo = {tag: timed(f"{tag}_serve", zoo_serve_phase, torch, arch, tag, layers, engines)
           for arch, tag, layers, engines in ZOO}
    # phase 11: serve whisper-medium whole and llava-next-34b (its depth cut)
    # through the serving steps with their embeddings, each freed before the
    # next is built
    frontend = {spec[1]: timed(f"{spec[1]}_serve", frontend_serve_phase, torch, *spec)
                for spec in FRONTEND}
    # phase 12: the distribution layer: B2's log-sum-exp form, a world-1
    # NCCL group's sharded gemma-2b steps against the train phase's, the
    # "mesh" backend against the host backend, and rank 0's share of the
    # single-pod mesh for three cells under the fake process group
    dist = timed("dist", dist_phase, torch, train)
    kern["decode_attention"].update(dist["lse_rows"])
    log("phases: " + " ".join(f"{k}={v:.1f}s" for k, v in phase_s.items()))

    # each kernel: its main-path launches (summed over the paths that run
    # it), its worst error over every case, and the times of its main case
    spec = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:193", "window=None",
            ("paged", "moe_paged", "h2o_paged", "command_r_paged")),
        "decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/dense_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:82", "per_row,window=None",
            ("slot", "wave", "hwperf_decode", "moe_slot", "moe_wave", "griffin_slot",
             "griffin_wave", "yi_slot", "h2o_slot", "command_r_slot", "whisper_eager",
             "whisper_compiled", "llava_eager", "llava_compiled", "llava_wave")),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:96", "S=512,window=None",
            ("slot", "wave", "hwperf_decode", "moe_slot", "moe_wave", "griffin_slot",
             "griffin_wave", "yi_slot", "h2o_slot", "command_r_slot", "whisper_eager",
             "whisper_compiled", "llava_eager", "llava_compiled", "llava_wave", "train",
             "moe_train", "griffin_train", "h2o_train", "whisper_train", "llava_train")),
        # the backward kernels replace XLA's autodiff of the JAX functions
        # (the JAX package has no backward kernel, no pallas_call); B3's in
        # its two forms, each with its own main path
        "flash_attention_bwd.mma": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            "src/repro/models/layers.py:103", "B=4,S=512,window=None,bfloat16",
            ("train", "moe_train", "griffin_train", "h2o_train", "whisper_train",
             "llava_train")),
        "flash_attention_bwd.simt": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            "src/repro/models/layers.py:103", "smoke,B=2,S=32,float32",
            ("small_train_gemma", "small_train_moe", "small_train_griffin", "small_train_yi",
             "small_train_h2o", "small_train_h2o_hd120", "small_train_command_r",
             "small_train_whisper", "small_train_llava")),
        # B2 returning each row's log-sum-exp beside its output: the
        # sequence-sharded decode's per-rank attention, merged over the ranks
        "decode_attention.lse": (
            "src/repro_torch/kernels/decode_attention/csrc/dense_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:82", "lse,decode_32k,shared,bfloat16",
            ("dist_decode",)),
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
        # the optimizer's clip norm and update over every leaf (XLA fuses the
        # JAX package's AdamW: no pallas_call); "replaces" names the function
        "adamw": (
            "src/repro_torch/kernels/adamw/csrc/adamw.cu",
            "src/repro/optim/adamw.py:57", "h2o,3.96B",
            ("train", "moe_train", "griffin_train", "mamba_train", "h2o_train", "whisper_train",
             "llava_train")),
    }
    runs = {**{p: r["launches"] for p, r in serve.items()},
            "hwperf_decode": hw["launches"],
            **{f"moe_{p}": r["launches"] for p, r in moe.items()},
            **{f"{tag}_{p}": recurrent[tag][p]["launches"] for _, tag, _ in RECURRENT
               for p in ("slot", "wave")},
            **{f"{tag}_{p}": zoo[tag][p]["launches"] for _, tag, _, engines in ZOO
               for p in engines},
            **{f"{tag}_{p}": frontend[tag][p]["launches"] for tag in frontend
               for p in ("eager", "compiled", "wave") if p in frontend[tag]},
            "lstm": {"lstm_cell": sum(lstm["launches"].values())},
            "lstm_grad": {k: sum(p[k] for p in lstm["grad"]["launches"].values())
                          for k in ("lstm_cell", "lstm_cell_bwd")},
            "train": train["launches"],
            **{tag: r["launches"] for tag, r in family_train.items()},
            **{f"small_train_{tag}": r["launches"] for tag, r in small_train.items()},
            "dist_decode": dist["cells"]["gemma-2b.decode_32k"]["run"]["launches"]}
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
        if name == "adamw":
            kernels[-1]["note"] = "XLA fuses the JAX package's AdamW; no pallas_call"
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
             "serve": serve, "hwperf": hw, "fleet": fleet,
             "moe_serve": moe, "recurrent_serve": recurrent, "zoo_serve": zoo,
             "frontend_serve": frontend, "dist": dist,
             "build_s": build_s,
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
