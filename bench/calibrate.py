"""Readings for the limits of a cell's check, on the chip, in one process.

    python bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --variants fp8,half_batch,token_altered

For each of ``--seeds``: the run's own set-up (the program's first steps and
the check's readings), then the reference, and the three numbers the check
compares (the program's lower readings).  For each of ``--control-seeds``:
the reference against a variant of itself put in the program's place, the
same three numbers (the upper readings):

* ``fp8``: every linear product's operands rounded to float8 e4m3 (the
  nearest precision below the configuration's bfloat16);
* ``half_batch``: half of each batch's rows left out, the mean over the rest;
* ``token_altered``: the first token of every row changed where it is fed;
* ``unchanged``: a step that returns its state unchanged (the losses of the
  first weights; the first moment stays 0 and nothing moves, so the
  gradient and the change read 1).
One JSON line per reading on standard output, with the worst leaves.  The
benchmark's own runs never run this.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def worst(prog: dict, ref: dict, n: int = 5) -> dict:
    """The ``n`` leaves with the largest gradient and change gaps."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        gaps = sorted(((abs(prog[key][p] - ref[key][p]) / max(ref[key][p], med), p)
                       for p in ref[key]), reverse=True)[:n]
        out[key] = [["".join(f"[{k!r}]" for k in p), g] for g, p in gaps]
    return out


def variant_batches(first: list, variant: str, vocab: int) -> list:
    if variant == "half_batch":
        return [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in first]
    if variant == "token_altered":
        out = []
        for b in first:
            t = b["tokens"].clone()
            t[:, 0] = (t[:, 0] + 1) % vocab
            out.append({"tokens": t, "labels": b["labels"]})
        return out
    return first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--variants", default="fp8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="a checkout whose BENCHMARK.json and bench/ define the cell "
                         "(a cell not yet, or no longer, in this one's)")
    args = ap.parse_args(argv)

    from harness import paths

    checkout = paths.setup()
    import torch

    from harness import check, spec, train, traffic
    from harness.weights import Weights
    from reference.follow import follow

    root = Path(args.root or checkout)
    cell = spec.load_cell(args.workload, root=root, bench=root / "bench")
    dev = torch.device(args.device)
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"

    def emit(seed, side, numbers, got, base, seconds, reference_s):
        print(json.dumps({"cell": cell.name, "seed": seed, "side": side, "kind": kind,
                          "numbers": {k: v for k, (v, _) in numbers.items()},
                          "loss": got["loss"], "ref_loss": base["loss"],
                          "worst": worst(got, base), "reference_s": reference_s,
                          "seconds": seconds}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        r = train.Run(cell=cell, seed=seed, device=dev)
        prog = train.start(r)
        train.free(r, prog)
        train.judge_reference(r, prog)
        emit(seed, "program", r.numbers, r.program, r.reference, time.perf_counter() - t0,
             r.reference_s)
        del prog, r

    model, mix = cell.config["model"], cell.traffic
    ref = spec.reference(cell.config, cell.bench)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        weights = Weights(ref.layout(model), seed, dev)
        first = traffic.batches(mix, model["vocab_size"], seed,
                                range(int(cell.limits["steps"])), dev)
        t0 = time.perf_counter()
        base = follow(ref, model, weights.flat(weights.make()), first, mix["optimizer"],
                      initial=weights.initial)
        base_s = time.perf_counter() - t0
        for variant in args.variants.split(","):
            t0 = time.perf_counter()
            opt = dict(mix["optimizer"], lr=0.0) if variant == "unchanged" else mix["optimizer"]
            got = follow(ref, model, weights.flat(weights.make()),
                         variant_batches(first, variant, model["vocab_size"]), opt,
                         precision="fp8" if variant == "fp8" else "fp32",
                         initial=weights.initial)
            if variant == "unchanged":
                got["grad"] = dict.fromkeys(got["grad"], 0.0)
                got["change"] = dict.fromkeys(got["change"], 0.0)
            emit(seed, variant, check.compare(got, base), got, base,
                 time.perf_counter() - t0, base_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
