#!/usr/bin/env python3
"""How the decode kernels' device time (B2 dense, B1 paged) scales with their
work, on one CUDA card.

    python3 scripts/torch_dense_decode_probe.py

Builds both sources with ``-Xptxas -v`` and prints each kernel's registers,
shared memory and spills.  Then runs ``decode_attention_cuda`` and
``paged_decode_attention_cuda`` at gemma-2b widths (8 query heads, 1 KV head,
hd 256, bf16) and granite's (16 / 8 heads of 64) and prints the device time
per call of each kernel name that ``torch.profiler`` records, in
microseconds, beside a tiny elementwise kernel as the floor of one launch:
B2 for a few batch sizes, cache lengths and kept fractions; B1 on the same
rows as pages of 16 (chip_smoke's mixed lengths, then every row at 1, 8 and
64 pages, which gives the time per page).  A time that does not grow with
the kept entries says the kernel waits on memory latency, not bytes.
Prints the card's name and power limit first.
"""
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

GEMMA = {"Hq": 8, "Hkv": 1, "hd": 256}
GRANITE = {"Hq": 16, "Hkv": 8, "hd": 64}
MIXED = [1024, 37, 512, 700, 333, 129, 1000, 0]     # chip_smoke's rows, one idle


def ptxas_summary(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) of each entry that ``-Xptxas -v`` reports;
    the kernel as the template arguments of its mangled name."""
    rows, entry, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.search(r"\d+([a-z_]+)I(\w+?)EEvP", m.group(1))
            entry = f"{args.group(1)}<{args.group(2)}>" if args else m.group(1)[-60:]
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "registers" in ln:
            rows.append((entry, re.search(r"Used \d+ registers", ln).group(0), spill))
    return rows


def per_call_us(torch, fn, iters: int = 50) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    kernels = launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:48]] = out.get(e.name[:48], 0.0) + (e.time_range.end - e.time_range.start)
            kernels += "memcpy" not in e.name.lower() and "memset" not in e.name.lower()
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            launches += 1
    # the profiler can drop a short kernel's device record, never its launch
    scale = launches / kernels if kernels and launches > kernels else 1.0
    return {k: round(v * scale / iters, 2) for k, v in out.items()}


def split_note(ops, **kw) -> str:
    """The cluster size and chunk the wrapper picks, where it has such a choice."""
    pick = getattr(ops, "decode_split", None)
    return "" if pick is None else " split=%s" % (pick(**kw),)


def dense_rows(torch, ops, gen, lengths, S, Hq, Hkv, hd):
    B = len(lengths)
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    pos = torch.full((B, S), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        pos[b, :n] = torch.arange(n, dtype=torch.int32)
    qp = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    pos, qp = pos.cuda(), qp.cuda()
    note = split_note(ops, n_entries=S, itemsize=2, hd=hd, clusters=B * Hkv)
    return note, per_call_us(torch, lambda: ops.decode_attention_cuda(q, k, v, pos, qp, None))


def paged_rows(torch, ops, gen, lengths, n_pt, Hq, Hkv, hd, ps=16):
    B = len(lengths)
    P = B * n_pt
    q = torch.randn((B, Hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(P, generator=gen, device="cuda").tolist()
    table = torch.full((B, n_pt), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            table[b, j] = perm[b * n_pt + j]
    qp = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    table, qp = table.cuda(), qp.cuda()
    note = split_note(ops, n_entries=n_pt * ps, itemsize=2, hd=hd, clusters=B * Hkv)
    return note, per_call_us(
        torch, lambda: ops.paged_decode_attention_cuda(q, k, v, table, qp, None))


def main() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name, b in _build.build_all(["dense_decode", "paged_decode"], verbose=True).items():
        for entry, regs, spill in ptxas_summary(b["log"]):
            print(f"ptxas {name}: {entry} {regs} {spill}")
    x = torch.zeros(1024, device="cuda")
    print("tiny add (one-launch floor)", per_call_us(torch, lambda: x.add_(1)))
    gen = torch.Generator(device="cuda").manual_seed(0)

    for tag, shape in (("gemma", GEMMA), ("granite", GRANITE)):
        note, t = dense_rows(torch, ops, gen, MIXED, 1024, **shape)
        print(f"B2 {tag} per_row mixed S=1024{note}", t, flush=True)
        note, t = paged_rows(torch, ops, gen, MIXED, 64, **shape)
        print(f"B1 {tag} mixed n_pt=64{note}", t, flush=True)
    for pages in (1, 8, 64):
        note, t = paged_rows(torch, ops, gen, [16 * pages] * 8, 64, **GEMMA)
        print(f"B1 gemma B=8 every row {pages} page(s){note}", t, flush=True)
        note, t = dense_rows(torch, ops, gen, [16 * pages] * 8, 1024, **GEMMA)
        print(f"B2 gemma B=8 every row {16 * pages} entries{note}", t, flush=True)
    for B, S, kept in [(8, 1024, "none"), (8, 32, "all"), (1, 1024, "all"), (8, 4096, "all"),
                       (8, 1024, "first64")]:
        n = {"all": S, "none": 0, "first64": 64}[kept]
        note, t = dense_rows(torch, ops, gen, [n] * B, S, **GEMMA)
        print(f"B2 gemma B={B} S={S} kept={kept}{note}", t, flush=True)


if __name__ == "__main__":
    main()
