#!/usr/bin/env python3
"""The bf16 bar for B3's backward at the frontend shapes: a CPU model.

    python3 scripts/torch_flash_bwd_bar.py [--batch 1] [--seed 0] [--shapes all]

``chip_smoke.py`` holds the tensor-core backward's dq, dk and dv at the
frontend archs' training shapes (``FRONTEND_BWD``) to the plain backward
run in f32 on the same bf16 inputs (q, k, v, dout, the forward's bf16
output and f32 log-sum-exp), within ``BF16_BWD_ULPS`` bf16 ulps of each
output row's largest value (``bf16_row_ulps`` with ``BWD_ROW_FLOOR``).
This script models, in f64 on the CPU, what that bar reads for

* ``kernel``: the backward as the kernel computes it — P and dS handed to
  the products as three bf16 terms each (``split3`` in
  ``csrc/tensor_core.cuh``), the products exact, each result rounded to
  bf16 as the kernel stores it (the tensor cores' f32 summation is not
  modelled);
* ``split1``: a precision control, the same with P and dS as one bf16
  term each (what ``scripts/torch_train_probe.py --plant`` builds as its
  second planted copy);
* ``planted``: the copy ``--plant`` builds first, whose dK / dV walk stops
  one query tile (32 rows) short: dk and dv miss the last query tile's
  rows, dq is the kernel's;

each against the f64 gradient rounded to f32 (the plain backward in f32),
and prints per shape and gradient the max abs difference and its ulps.
Random bf16 inputs from ``--seed`` as chip_smoke draws them (its
generator is the card's, so the numbers differ, not their scale); batch
rows cut to ``--batch`` to fit the CPU (the bar is per row, so more rows
only add samples of the same distribution).
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _plain_forward  # noqa: E402

BF16, F64 = torch.bfloat16, torch.float64
KQT = 32                       # query rows a step of the dK / dV walk (csrc/flash_bwd.cu)
WAYS = ("exact", "kernel", "split1", "planted")


def split3(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of three bf16 terms: head, then the rounded rests."""
    out, rest = torch.zeros_like(x), x
    for _ in range(3):
        t = rest.to(BF16).to(F64)
        out, rest = out + t, rest - t
    return out


def split1(x: torch.Tensor) -> torch.Tensor:
    """x rounded to one bf16 term."""
    return x.to(BF16).to(F64)


def row_ulps(got: torch.Tensor, exact: torch.Tensor) -> float:
    return cs.bf16_row_ulps(torch, got, exact, cs.BWD_ROW_FLOOR)


def model(B, Sq, Skv, Hq, Hkv, hd, causal, seed) -> dict:
    """``{way: {dq, dk, dv}}`` in f64 for each of ``WAYS``: ``exact`` the
    f64 gradients rounded to f32, the others rounded to bf16.  One query
    head at a time (the score matrices of every head at once would not
    fit)."""
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, Sq, Hq, hd), generator=gen).to(BF16) for _ in range(2))
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=gen).to(BF16) for _ in range(2))
    G, scale = Hq // Hkv, hd ** -0.5
    keep = cs.flash_keep(torch, Sq, None, Skv, causal, device="cpu")
    # the planted walk's last query tile: rows 32 (ceil(Sq / 32) - 1) .. Sq - 1
    # for every key tile (its first tile is a multiple of 32)
    kept_rows = (torch.arange(Sq) < KQT * (-(-Sq // KQT) - 1)).to(F64)[:, None]
    terms = {"exact": lambda x: x, "kernel": split3, "split1": split1, "planted": split3}
    grads = {w: {"dq": torch.zeros((B, Sq, Hq, hd), dtype=F64),
                 "dk": torch.zeros((B, Skv, Hkv, hd), dtype=F64),
                 "dv": torch.zeros((B, Skv, Hkv, hd), dtype=F64)} for w in WAYS}
    for b in range(B):
        out, lse = _plain_forward(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal, None, 0, 1024, 512)
        for h in range(Hq):
            hk = h // G
            qf, dof = (t[b, :, h].to(F64) for t in (q, do))
            of = out[0, :, h].to(F64)
            kf, vf = k[b, :, hk].to(F64), v[b, :, hk].to(F64)
            s = qf @ kf.T * scale
            p = torch.where(keep, torch.exp(s - lse[0, h].to(F64)[:, None]), 0.0)
            D = (dof * of).sum(-1)
            ds = p * (dof @ vf.T - D[:, None])
            for way in WAYS:
                pp, dss = terms[way](p), terms[way](ds)
                g = grads[way]
                g["dq"][b, :, h] = dss @ kf * scale
                rows = kept_rows if way == "planted" else 1.0
                g["dk"][b, :, hk] += (dss * rows).T @ qf * scale
                g["dv"][b, :, hk] += (pp * rows).T @ dof
    return {w: {n: t.to(torch.float32 if w == "exact" else BF16).to(F64) for n, t in g.items()}
            for w, g in grads.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1, help="batch rows of each shape (at most "
                                                         "the shape's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="all",
                    help="comma-separated indices into chip_smoke's FRONTEND_BWD")
    args = ap.parse_args()
    shapes = cs.FRONTEND_BWD
    pick = range(len(shapes)) if args.shapes == "all" else map(int, args.shapes.split(","))
    for i in pick:
        B, Sq, Skv, causal, heads, tag = shapes[i]
        Hq, Hkv, hd = heads["Hq"], heads["Hkv"], heads["hd"]
        B = min(B, args.batch)
        got = model(B, Sq, Skv, Hq, Hkv, hd, causal, args.seed + i)
        exact = got.pop("exact")
        for way, g in got.items():
            print(f"{tag} (B={B} Sq={Sq} Skv={Skv} {Hq}/{Hkv} heads of {hd} causal={causal}) "
                  f"{way}: " + "; ".join(
                      f"{n} max abs err {(g[n] - exact[n]).abs().max().item():.3e} = "
                      f"{row_ulps(g[n], exact[n]):.2f} ulps" for n in ("dq", "dk", "dv")),
                  flush=True)


if __name__ == "__main__":
    main()
