#!/usr/bin/env python3
"""How B3's backward must feed P and dS to bf16 tensor cores: a CPU model.

    python3 scripts/torch_flash_bwd_rounding.py [--seeds 0,1,2] [--batch 4]

The tensor-core backward multiplies P and dS (f32) by bf16 operands, so it
must hand them over in bf16.  This script computes, in f64 on the CPU, the
gradients of gemma-2b's training attention (S = 512, 8 / 1 heads of 256,
causal, random bf16 inputs from each seed) three ways, each rounding P and
dS before the products dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K:

* ``f32``: P and dS rounded to f32 (what the SIMT kernel keeps);
* ``bf16``: rounded once to bf16 (what the forward does to P);
* ``bf16 x2`` / ``bf16 x3``: as the sum of two / three bf16 terms (head,
  then the rounded rests: ``split3`` in ``csrc/tensor_core.cuh`` for three).

It rounds each result to bf16 as the kernel stores it and prints, per way
and gradient, the max abs difference from the f64 gradient rounded to bf16
(the check's 3e-2 bar) and how many outputs differ from it (by a bf16
step or more).
The products themselves are exact here: the tensor cores' own summation
is not modelled.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels.flash_attention.ops import _plain_forward  # noqa: E402

BF16, F64 = torch.bfloat16, torch.float64


def _round(x):
    return x.to(BF16).to(F64)


def _terms(n):
    def split(x):
        out, rest = torch.zeros_like(x), x
        for _ in range(n):
            t = _round(rest)
            out, rest = out + t, rest - t
        return out
    return split


WAYS = {"f32": lambda x: x.float().to(F64), "bf16": _round, "bf16 x2": _terms(2),
        "bf16 x3": _terms(3)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    B, S, Hq, Hkv, hd = args.batch, 512, 8, 1, 256
    G, scale = Hq // Hkv, hd ** -0.5
    worst = {(w, n): [0.0, 0] for w in WAYS for n in ("dq", "dk", "dv")}
    for seed in (int(x) for x in args.seeds.split(",")):
        torch.manual_seed(seed)
        q, do = (torch.randn(B, S, Hq, hd).to(BF16) for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, hd).to(BF16) for _ in range(2))
        out, lse = _plain_forward(q, k, v, True, None, 0, 1024, 512)
        qf, dof = (t.to(F64).reshape(B, S, Hkv, G, hd) for t in (q, do))
        kf, vf = k.to(F64), v.to(F64)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        p = torch.where(keep, torch.exp(s - lse.to(F64).reshape(B, Hkv, G, S)[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
        D = (do.to(F64) * out.to(F64)).sum(-1).reshape(B, S, Hkv, G).permute(0, 2, 3, 1)
        ds = p * (dp - D[..., None])

        def grads(pp, dss):
            return {"dq": torch.einsum("bhgqk,bkhd->bqhgd", dss, kf) * scale,
                    "dk": torch.einsum("bhgqk,bqhgd->bkhd", dss, qf) * scale,
                    "dv": torch.einsum("bhgqk,bqhgd->bkhd", pp, dof)}
        ref = {n: t.to(BF16).float() for n, t in grads(p, ds).items()}
        for way, fn in WAYS.items():
            for n, t in grads(fn(p), fn(ds)).items():
                d = (t.to(BF16).float() - ref[n]).abs()
                w = worst[(way, n)]
                w[0] = max(w[0], d.max().item())
                w[1] += int((d > 0).sum())
        print(f"seed {seed} done", flush=True)
    for (way, n), (err, flips) in worst.items():
        print(f"{way:8s} {n}: max abs err {err:.3e}{' (past 3e-2)' if err > 3e-2 else ''}, "
              f"{flips} outputs differ")


if __name__ == "__main__":
    main()
