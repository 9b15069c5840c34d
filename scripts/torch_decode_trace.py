#!/usr/bin/env python3
"""Where a decode-core launch (B1 / B2) spends its time, phase by phase, on
one CUDA card.

    python3 scripts/torch_decode_trace.py

Builds a copy of ``csrc/decode_core.cuh`` with ``%globaltimer`` stamps at
its phase boundaries (start; metadata in; then per chunk: copies landed,
scores, softmax, P.V; then the CTA's state written, the first cluster sync,
the merge, the end) into ``build/decode_trace/``, runs the dense entry at
chip_smoke's mixed rows (gemma-2b and granite-moe-1b-a400m widths, bf16,
S = 1024) and prints, for CTA 0 of row 0, the microseconds from its start
to each stamp, and over all CTAs the spread of start times (a second wave
shows there) and the median CTA duration.  Then it times the same calls
through the real kernel at every cluster size and both chunk sizes the core
takes (device µs per call from ``torch.profiler``), the evidence behind
``decode_split``.  Prints the card's name and power limit first.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "decode_attention" / "csrc"
SLOTS = 64                       # stamps per CTA
# (anchor in the core, stamp slot, stamp after the anchor or before it)
MARKS = [
    ("  const int hd = a.hd, chunk = a.chunk;\n", "0", "after"),
    ("entry_row<PAGED>(a, words[k], w0 + i, qp) : -1;\n    }\n    __syncthreads();\n", "1", "after"),
    ("this chunk's copies have landed\n      __syncthreads();\n", "2 + 4 * ci_", "after"),
    ("\n      // 2. online softmax", "3 + 4 * ci_", "before"),
    ("\n      // 3. P.V", "4 + 4 * ci_", "before"),
    ("everyone is done with this stage before it refills\n", "5 + 4 * ci_", "after"),
    ("  // the CTA's (acc, m, l) for its peers", "60", "before"),
    ("  int row_kept = 0;", "61", "before"),
    ("  cluster.sync();   // peers may still read", "62", "before"),
    ("peers may still read this CTA's shared memory until here\n", "63", "after"),
]


def stamp(slot: str, guard: bool = True) -> str:
    cond = "threadIdx.x == 0" + (" && ci_ < 14" if guard else "")
    return (f"  if ({cond}) {{ unsigned long long t_; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            "g_trace[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * "
            f"{SLOTS} + {slot}] = t_; }}\n")


def traced_source() -> str:
    src = (CSRC / "decode_core.cuh").read_text()
    src = src.replace("// One CTA: rank", f"__device__ unsigned long long g_trace[{SLOTS} * 65536];\n"
                      "// One CTA: rank", 1)
    for anchor, slot, where in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"the core no longer has one {anchor!r}")
        i = src.index(anchor) + (len(anchor) if where == "after" else 0)
        text = stamp(slot, "ci_" in slot)
        if slot == "0":
            text = "  int ci_ = 0;\n" + text
        elif slot.startswith("5"):
            text += "  ++ci_;\n"
        src = src[:i] + text + src[i:]
    return src


def build(out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_core.cuh").write_text(traced_source())
    cu = (CSRC / "dense_decode.cu").read_text()
    cu += ('\nextern "C" int dump_trace(void* dst, int n) '
           '{ return (int)cudaMemcpyFromSymbol(dst, g_trace, n * 8); }\n'
           'extern "C" int reset_trace(const void* src, int n) '
           '{ return (int)cudaMemcpyToSymbol(g_trace, src, n * 8); }\n')
    (out / "dense_trace.cu").write_text(cu)
    lib = out / "libdense_trace.so"
    subprocess.run([_build._nvcc(), *_build._ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(out / "dense_trace.cu")],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.dense_decode_attention.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                                           + [ctypes.c_float, ctypes.c_void_p])
    dll.dump_trace.argtypes = dll.reset_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def case(torch, Hq, Hkv, hd, S=1024, seed=0):
    from torch_dense_decode_probe import MIXED

    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = len(MIXED)
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    pos = torch.full((B, S), -1, dtype=torch.int32)
    for b, n in enumerate(MIXED):
        pos[b, :n] = torch.arange(n, dtype=torch.int32)
    qp = torch.tensor([max(n - 1, 0) for n in MIXED], dtype=torch.int32)
    return q, k, v, pos.cuda(), qp.cuda()


def launcher(torch, fn, args, n_c, chunk):
    q, k, v, pos, qp = args
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    out = torch.empty_like(q)

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), qp.data_ptr(),
                 out.data_ptr(), 1, B, S, Hq, Hkv, hd, 1, 1, n_c, chunk, 0, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def main() -> None:
    import torch

    from torch_dense_decode_probe import per_call_us
    from repro_torch.kernels.decode_attention import ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dll = build(ROOT / "build" / "decode_trace")
    names = {0: "start", 1: "metadata", 60: "state", 61: "cluster sync", 62: "merged",
             63: "end"}
    for tag, shape, splits in (("gemma", (8, 1, 256), (1, 2, 4, 8)),
                               ("granite", (16, 8, 64), (1, 2, 4, 8))):
        args = case(torch, *shape)
        n_c, chunk = ops._split_for(args[0], args[1].shape[1], shape[1])
        call = launcher(torch, dll.dense_decode_attention, args, n_c, chunk)
        B = args[0].shape[0]
        n = n_c * shape[1] * B
        call()                                   # warm: module load, caches
        torch.cuda.synchronize()
        dll.reset_trace(np.zeros(n * SLOTS, np.uint64).ctypes.data, n * SLOTS)
        call()
        torch.cuda.synchronize()
        buf = np.zeros(n * SLOTS, np.uint64)
        if dll.dump_trace(buf.ctypes.data, n * SLOTS):
            raise RuntimeError("reading the trace failed")
        tr = buf.reshape(n, SLOTS).astype(np.int64)
        row = tr[0]
        marks = []
        for slot in range(SLOTS):
            if row[slot]:
                name = names.get(slot) or (f"chunk{(slot - 2) // 4}:"
                                           + ("landed", "scores", "softmax", "P.V")[(slot - 2) % 4])
                marks.append(f"{name} {(row[slot] - row[0]) / 1e3:.2f}")
        starts, ends = tr[:, 0], tr[:, 63]
        print(f"trace {tag} mixed rows, n_c={n_c} chunk={chunk}, CTA 0 (us from its start): "
              + ", ".join(marks))
        print(f"trace {tag}: {n} CTAs, start spread {(starts.max() - starts.min()) / 1e3:.2f} us, "
              f"median CTA {np.median(ends - starts) / 1e3:.2f} us, "
              f"span {(ends.max() - starts.min()) / 1e3:.2f} us")
        real = ops._dense_lib().dense_decode_attention
        times = {f"n_c={c},chunk={ch}": round(sum(per_call_us(
            torch, launcher(torch, real, args, c, ch)).values()), 2)
            for c in splits for ch in (64, 32)}
        print(f"split {tag} mixed rows (device us per call; picked n_c={n_c} chunk={chunk}):",
              times, flush=True)


if __name__ == "__main__":
    main()
