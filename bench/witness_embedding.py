"""Where a cell's embedding gradient gap comes from, on the chip.

    python bench/witness_embedding.py --workload <cell> --seed <n> [--root <checkout>]

Runs the cell's set-up (the program's first steps), keeps the program's
first gradient of the embedding (its first moment after step 1, over
``1 - b1``), then the float32 reference's step 1, and compares them row by
row, by how often each token occurs in the batch, beside two witnesses
built from the reference's own gradient at each occurrence: summed into a
bfloat16 table by ``index_put_(accumulate=True)`` (the kernel the program's
backward runs) and summed into a float32 table.  Prints one JSON line.
``--root`` names a checkout whose ``BENCHMARK.json`` defines the cell (one
that is out of this one's).  The benchmark's own runs never run this.
"""
import argparse
import json
import math
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from harness import paths

    checkout = paths.setup()
    import torch

    from harness import spec, train

    root = Path(args.root or checkout)
    cell = spec.load_cell(args.workload, root=root, bench=root / "bench")
    model, opt = cell.config["model"], cell.traffic["optimizer"]
    kept = {}

    def hook(step):
        def wrapped(state, batch):
            out = step(state, batch)
            if "embed" not in kept:
                kept["embed"] = out[0]["m"]["embed"].float().div(1 - opt["b1"]).clone()
            return out
        return wrapped

    r = train.Run(cell=cell, seed=args.seed, device=torch.device(args.device))
    prog = train.start(r, step_hook=hook)
    train.free(r, prog)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = spec.reference(cell.config, cell.bench)
    seen = {}
    loss, grads, _ = ref.loss_and_grads(model, prog.weights.flat(prog.weights.make()),
                                        prog.first[0], keep=seen)
    scale = min(opt["clip_norm"] / math.sqrt(sum(float((g * g).sum()) for g in grads.values())),
                1.0)
    g_ref = grads[("embed",)] * scale
    del grads
    dx = seen["embed_dx"].reshape(-1, model["d_model"]).bfloat16()
    tok = prog.first[0]["tokens"].long().reshape(-1)
    rows = g_ref.shape[0]
    as_bf16 = torch.zeros(rows, dx.shape[1], dtype=torch.bfloat16, device=dx.device).index_put_(
        (tok,), dx, accumulate=True).float() * scale
    as_f32 = torch.zeros(rows, dx.shape[1], device=dx.device).index_put_(
        (tok,), dx.float(), accumulate=True) * scale
    counts = torch.bincount(tok, minlength=rows)

    def norm(t):
        return float(torch.linalg.vector_norm(t))

    sides = {"program": kept["embed"], "bf16_witness": as_bf16, "f32_witness": as_f32}
    out = {"cell": cell.name, "seed": args.seed, "loss1": r.program["loss"][0], "ref_loss1": loss,
           "leaf_gap": {k: abs(norm(v) - norm(g_ref)) / norm(g_ref) for k, v in sides.items()}}
    out["top_rows"] = [
        {"token": t, "count": int(counts[t]),
         **{f"{k}/ref": norm(v[t]) / norm(g_ref[t]) for k, v in sides.items()},
         "coherence": norm(seen["embed_dx"].reshape(-1, model["d_model"])[tok == t].sum(0))
         / float(seen["embed_dx"].reshape(-1, model["d_model"])[tok == t].norm(dim=1).sum())}
        for t in torch.argsort(counts, descending=True)[:8].tolist()]
    out["by_count"] = {}
    for lo, hi in ((1, 10), (10, 100), (100, 1000), (1000, 1 << 40)):
        sel = (counts >= lo) & (counts < hi)
        if int(sel.sum()):
            out["by_count"][f"{lo}-{hi}"] = {
                "rows": int(sel.sum()),
                "share_of_ref_norm2": norm(g_ref[sel]) ** 2 / norm(g_ref) ** 2,
                **{f"{k}/ref": norm(v[sel]) / norm(g_ref[sel]) for k, v in sides.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
