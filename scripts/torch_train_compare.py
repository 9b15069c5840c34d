#!/usr/bin/env python3
"""Train full-width gemma-2b with this tree and another, in turns, on one card.

    python3 scripts/torch_train_compare.py OTHER_TREE [--rounds N]

Runs ``chip_smoke.train_phase`` (3 AdamW steps at B=4, S=512 with remat,
a checkpoint restored bit for bit, one step under ``torch.profiler``) of
OTHER_TREE (a checkout of another commit, e.g. ``git archive`` of the
parent unpacked into the git-ignored ``scratch_chip/``) and of this tree,
each in a fresh process that builds its own kernels, in the order other,
this, this, other (``--rounds`` repeats the pair of pairs).  Prints per run
the ms/step p50, tokens/s, peak memory, device busy ms of the profiled
step and the ms a step of B3's backward kernels (``flash_bwd`` in the
kernel name), then one ``compare`` JSON line with every run.  Both trees
must be on the same card in one call for their numbers to compare.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(0, root + '/src')
import chip_smoke, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
res = chip_smoke.train_phase(torch)
prof = res['device_profile']
bwd = {n: ms for n, ms in prof.get('by_kernel', {}).items() if 'flash_bwd' in n}
keys = ('ms_per_step_p50', 'tokens_per_s', 'peak_memory_gb', 'step_s', 'losses', 'grad_norms',
        'adamw_ms')
print('RESULT ' + json.dumps({**{k: res[k] for k in keys},
                              'busy_ms': prof.get('device_busy_ms_per_step'),
                              'wall_ms': prof.get('wall_ms_per_step'),
                              'flash_bwd_ms_per_step': sum(bwd.values()), 'flash_bwd': bwd}),
      flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    other = str(Path(args.other).resolve())
    if not (Path(other) / "chip_smoke.py").is_file():
        sys.exit(f"{other} holds no chip_smoke.py")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs: dict[str, list] = {"other": [], "this": []}
    failed = 0
    for _ in range(args.rounds):
        for tag, root in (("other", other), ("this", str(ROOT)), ("this", str(ROOT)),
                          ("other", other)):
            res = subprocess.run([sys.executable, "-c", RUN, root], capture_output=True,
                                 text=True)
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
            if res.returncode or not lines:
                failed += 1
                print(f"{tag}: FAILED rc={res.returncode}\n{res.stderr[-3000:]}", flush=True)
                continue
            r = json.loads(lines[-1][len("RESULT "):])
            runs[tag].append(r)
            print(f"{tag}: ms/step p50 {r['ms_per_step_p50']:.2f} ({r['tokens_per_s']:.0f} "
                  f"tokens/s), peak {r['peak_memory_gb']:.2f} GB, profiled step wall "
                  f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.2f} ms, B3 backward "
                  f"{r['flash_bwd_ms_per_step']:.3f} ms/step", flush=True)
    print("compare " + json.dumps(runs))
    if failed:
        sys.exit(f"{failed} run(s) failed")


if __name__ == "__main__":
    main()
