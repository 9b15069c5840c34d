#!/usr/bin/env python3
"""Where an RG-LRU scan launch (B7) spends its time: waiting on memory or
walking the chain, on one CUDA card.

    python3 scripts/torch_scan_trace.py [--source PATH] [--no-sweep]

Builds a copy of the kernel with ``%globaltimer`` stamps into
``build/scan_trace/`` and runs it at recurrentgemma-2b's prefill shapes
(R = 2560: a 333-token prompt in the slot engine, B = 1, and in the wave
engine, B = 4; a 2048-token prompt).  A stamp is taken once the value it
is given is ready, so a stamp after the loads of a batch waits for them.
For each case it prints, for CTA 0's first chain, each chunk's wait (the
chain waits for its inputs) and chain (the updates of that chunk), in
microseconds, their sums, and the same sums' medians over every CTA; the
spread of CTA start times (a second wave shows there), the median CTA
and the span.

``--source`` names the kernel source (default: the repo's
``rglru_scan.cu``); ``--tiles C,CHUNK,STAGES`` overrides the tiling.  A source with ``RGLRU_STAMP`` hooks (the staged
kernel) is included with the stamps defined: its chunks are the ring's.
The one-thread-per-channel kernel that came before it (no hooks) gets
stamps inserted at its batch boundaries: its "chunks" are batches of 16
steps, wait = the batch's loads, chain = its 16 updates.

Then, unless ``--no-sweep`` (and for the staged kernel only), it times the
real kernel at each case for every channel width (8, 16, 32), chunk (64,
128) and ring depth (2, 4) (device µs per call from ``torch.profiler``,
the median of three turns), the evidence behind ``scan_tiles``.  Prints
the card's name and power limit, the floor of one launch (a tiny
elementwise kernel) and the chain's own floor (``FLOOR_SRC``: one warp a
CTA walking the recurrence with nothing to wait on) first.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "rglru_scan" / "csrc" / "rglru_scan.cu"
SLOTS = 512                      # stamps per CTA: start, end, 4 kinds x 127 chunks
MAX_CTAS = 4096
CASES = [(1, 333, 2560), (4, 333, 2560), (1, 2048, 2560)]

PRELUDE = f"""
#include <stdint.h>
__device__ unsigned long long g_trace[{SLOTS} * {MAX_CTAS}];
__device__ __forceinline__ void rglru_stamp_(int kind, int k, float dep) {{
  __shared__ volatile float sink_;
  const int slot = kind == 0 ? 0 : kind == 5 ? 1 : k < 127 ? 2 + (kind - 1) * 127 + k : -1;
  const unsigned cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (slot < 0 || cta >= {MAX_CTAS}) return;
  sink_ = dep;                   // waits for dep: the warp issues in order
  unsigned long long t_;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) :: "memory");
  g_trace[(size_t)cta * {SLOTS} + slot] = t_;
}}
#define RGLRU_STAMP(kind, k, dep) rglru_stamp_((kind), (k), (dep))
"""
EPILOGUE = f"""
extern "C" int dump_trace(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}}
extern "C" int reset_trace() {{
  void* p; cudaGetSymbolAddress(&p, g_trace);
  return (int)cudaMemset(p, 0, sizeof(g_trace));
}}
"""
# The chain's floor: 160 CTAs of one warp, 16 live lanes each walking
# h = a * h + b from h = 0 and storing every h at a stride of R floats, as
# the staged kernel's chain does, with a and b from registers (kFromSmem
# false) or from a [64 x 16] shared-memory tile at constant offsets.
FLOOR_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <bool kFromSmem>
__global__ void chain_floor(const float* __restrict__ g, float* __restrict__ hs, int64_t S,
                            int64_t R) {
  __shared__ float sa[64 * 16], sb[64 * 16];
  const int lane = threadIdx.x;
  for (int i = lane; i < 64 * 16; i += 32) { sa[i] = g[i]; sb[i] = g[1024 + i]; }
  __syncwarp();
  if (lane >= 16) return;
  const float xa = sa[lane], xb = sb[lane];
  float h = 0.f;
  float* o = hs + blockIdx.x * 16 + lane;
  for (int64_t t0 = 0; t0 + 64 <= S; t0 += 64) {
#pragma unroll
    for (int u = 0; u < 64; ++u) {
      h = kFromSmem ? __fadd_rn(__fmul_rn(sa[u * 16 + lane], h), sb[u * 16 + lane])
                    : __fadd_rn(__fmul_rn(xa, h), xb);
      *o = h;
      o += R;
    }
  }
  hs[blockIdx.x * 16 + lane] = h;
}
extern "C" int chain_floor_fwd(int smem, const void* g, void* hs, long long S, long long R,
                               void* stream) {
  auto k = smem ? chain_floor<true> : chain_floor<false>;
  k<<<160, 32, 0, (cudaStream_t)stream>>>((const float*)g, (float*)hs, S, R);
  return (int)cudaGetLastError();
}
"""
# the one-thread-per-channel kernel: (anchor, text inserted after it)
DIRECT_MARKS = [
    ("  if (ch >= B * R) return;\n", "  if (threadIdx.x == 0) RGLRU_STAMP(0, 0, 0.0f);\n"),
    ("    float av[kUnroll], bv[kUnroll];\n",
     "    if (threadIdx.x == 0) RGLRU_STAMP(1, (int)(t0 / kUnroll), h);\n"),
    ("      bv[u] = t < S ? b[base + t * R] : 0.0f;\n    }\n",
     "    if (threadIdx.x == 0) RGLRU_STAMP(2, (int)(t0 / kUnroll), "
     "av[kUnroll - 1] + bv[kUnroll - 1]);\n"),
    ("      hs[base + t * R] = h;\n    }\n",
     "    if (threadIdx.x == 0) RGLRU_STAMP(3, (int)(t0 / kUnroll), h);\n"),
    ("  h_last[ch] = h;\n", "  if (threadIdx.x == 0) RGLRU_STAMP(5, 0, h);\n"),
]


def traced_source(src: str, path: Path) -> tuple[str, bool]:
    """The traced translation unit and whether the kernel is the staged one."""
    if "RGLRU_STAMP" in src:
        return PRELUDE + f'#include "{path.resolve()}"\n' + EPILOGUE, True
    for anchor, text in DIRECT_MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"the kernel has no single {anchor!r}")
        i = src.index(anchor) + len(anchor)
        src = src[:i] + text + src[i:]
    return PRELUDE + src + EPILOGUE, False


def build(source: Path, out: Path) -> tuple[ctypes.CDLL, bool]:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    text, staged = traced_source(source.read_text(), source)
    cu = out / "rglru_trace.cu"
    cu.write_text(text)
    lib = out / "librglru_trace.so"
    subprocess.run([_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.rglru_scan_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                                   + ([ctypes.c_int] * 3 if staged else []) + [ctypes.c_void_p])
    dll.rglru_scan_fwd.restype = ctypes.c_int
    dll.dump_trace.argtypes = [ctypes.c_void_p]
    return dll, staged


def chain_floor(torch, per_call_us, out: Path) -> None:
    """Device µs of the chain alone (``FLOOR_SRC``) at 320 and 2048 steps,
    and ns a step: what no tiling of the staged kernel can beat."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "chain_floor.cu", out / "libchain_floor.so"
    cu.write_text(FLOOR_SRC)
    subprocess.run([_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).chain_floor_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    g = torch.rand(2048, device="cuda") * 0.9
    hs = torch.empty(2048 * 2560, device="cuda")
    for S in (320, 2048):
        for smem in (0, 1):
            us = sum(per_call_us(torch, lambda: fn(smem, g.data_ptr(), hs.data_ptr(), S, 2560,
                                                   torch.cuda.current_stream().cuda_stream),
                                 iters=50).values())
            print(f"chain floor S={S} a, b from {'shared memory' if smem else 'registers'}: "
                  f"{us:.2f} us, {1e3 * us / S:.2f} ns a step", flush=True)


def inputs(torch, B, S, R, seed=0):
    """The model's distributions (chip_smoke's ``rglru_scan_case``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lam = torch.log(torch.expm1(torch.linspace(0.3, 1.3, R, device="cuda")))
    r = torch.rand((B, S, R), generator=gen, device="cuda")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    b = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * torch.randn((B, S, R), generator=gen,
                                                                      device="cuda")
    return a, b


def launcher(torch, fn, a, b, tiles):
    B, S, R = a.shape
    hs = torch.empty_like(a)
    hl = torch.empty((B, R), device="cuda")

    def call():
        err = fn(a.data_ptr(), b.data_ptr(), None, hs.data_ptr(), hl.data_ptr(), B, S, R,
                 *tiles, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call, hs, hl


def summarise(tag: str, tr: np.ndarray) -> None:
    tr = tr[tr[:, 0] > 0].astype(np.int64)
    us = lambda x: x / 1e3                                     # noqa: E731
    kind = lambda k: tr[:, 2 + (k - 1) * 127: 2 + k * 127]      # noqa: E731
    t1, t2, t3, t4 = kind(1), kind(2), kind(3), kind(4)
    have = (t1 > 0) & (t2 > 0) & (t3 > 0)
    wait = np.where(have, t2 - t1, 0)
    chain = np.where(have, t3 - t2, 0)
    n = int(have[0].sum())
    per = ", ".join(f"{us(wait[0, k]):.2f}/{us(chain[0, k]):.2f}" for k in range(min(n, 12)))
    start, end = tr[:, 0], tr[:, 1]
    # CTA 0 outside its waits and chains: before the first wait, between a
    # chunk's chain and the next wait, after the last chain
    gaps = (t1[0, 0] - start[0], (t1[0, 1:n] - t3[0, :n - 1]).sum(), end[0] - t3[0, n - 1])
    print(f"trace {tag}: CTA 0, {n} chunks, wait/chain us per chunk: {per}"
          + (" ..." if n > 12 else ""))
    print(f"trace {tag}: CTA 0 outside them: {us(gaps[0]):.2f} us before the first wait, "
          f"{us(gaps[1]):.2f} between chunks, {us(gaps[2]):.2f} after the last")
    print(f"trace {tag}: CTA 0 wait {us(wait[0].sum()):.2f} us + chain {us(chain[0].sum()):.2f} "
          f"us of {us(end[0] - start[0]):.2f} us (first wait {us(wait[0, 0]):.2f}); "
          f"median over {len(tr)} CTAs: wait {us(np.median(wait.sum(1))):.2f}, chain "
          f"{us(np.median(chain.sum(1))):.2f}, CTA {us(np.median(end - start)):.2f}; start "
          f"spread {us(start.max() - start.min()):.2f}, span {us(end.max() - start.min()):.2f}")
    if (t4[0] > 0).any():
        lead = [us(t1[0, k] - t4[0, k]) for k in range(min(n, 12)) if t4[0, k] > 0]
        print(f"trace {tag}: CTA 0, copies of chunk k issued this many us before the chain "
              "waits for it: " + ", ".join(f"{x:.2f}" for x in lead))


def main() -> None:
    import torch

    from torch_dense_decode_probe import per_call_us

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--tiles", help="channels,chunk,stages for every case (default: "
                    "scan_tiles' pick)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    x = torch.zeros(1024, device="cuda")
    print("tiny add (one-launch floor)", per_call_us(torch, lambda: x.add_(1)), flush=True)
    chain_floor(torch, per_call_us, ROOT / "build" / "scan_trace")
    dll, staged = build(args.source, ROOT / "build" / "scan_trace")
    if staged:
        from repro_torch.kernels.rglru_scan import ops
    for B, S, R in CASES:
        a, b = inputs(torch, B, S, R)
        tiles = (() if not staged else tuple(int(x) for x in args.tiles.split(","))
                 if args.tiles else tuple(ops.scan_tiles(B, S, R)))
        call, hs, hl = launcher(torch, dll.rglru_scan_fwd, a, b, tiles)
        call()                                      # warm: module load, caches
        torch.cuda.synchronize()
        if dll.reset_trace():
            raise RuntimeError("clearing the trace failed")
        call()
        torch.cuda.synchronize()
        buf = np.zeros(SLOTS * MAX_CTAS, np.uint64)
        if dll.dump_trace(buf.ctypes.data):
            raise RuntimeError("reading the trace failed")
        tag = f"{'staged' if staged else 'direct'} B={B} S={S} R={R}" + (
            f" tiles={tiles}" if staged else "")
        summarise(tag, buf.reshape(MAX_CTAS, SLOTS))
        if staged and not args.no_sweep:
            real = ops._lib().rglru_scan_fwd
            grid = [(ch, chunk, stages) for ch in (8, 16, 32) for chunk in (64, 128)
                    for stages in (2, 4)]
            runs = {g: [] for g in grid}
            for _ in range(3):                      # the tilings in turn, three times
                for g in grid:
                    fn, *_ = launcher(torch, real, a, b, g)
                    runs[g].append(sum(per_call_us(torch, fn, iters=50).values()))
            times = {",".join(map(str, g)): round(float(np.median(v)), 2)
                     for g, v in runs.items()}
            best = min(times, key=times.get)
            print(f"sweep B={B} S={S} R={R} (channels,chunk,stages -> device us; picked "
                  f"{tiles}, best {best}):", times, flush=True)


if __name__ == "__main__":
    main()
