"""A benchmark of the smoke configurations, written into a temporary
directory beside copies of the real readers, formulas and references, for
the CPU tests: the same harness at sizes a test run can hold."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_MODELS = {
    "h2o-smoke": ("repro_torch.configs.h2o_danube3_4b:SMOKE", {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 512, "sliding_window": 16, "n_experts": 0, "top_k": 0}),
    "granite-smoke": ("repro_torch.configs.granite_moe_1b_a400m:SMOKE", {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 32, "vocab_size": 512, "sliding_window": None, "n_experts": 8, "top_k": 2}),
}
# each smoke cell's own limits, set from its readings on the CPU over a dozen
# seeds (the program's bf16, the control, the faults of test_bench_faults.py);
# the real cells' limits are for their real sizes
SMOKE_LIMITS = {
    "h2o-smoke": {"loss_gap": 0.01, "grad_gap": 0.01, "change_gap": 0.02},
    "granite-smoke": {"loss_gap": 0.01, "grad_gap": 0.12, "change_gap": 0.3},
}
_COMMON = {"rope_theta": 10000.0, "norm_eps": 1e-6, "act": "silu", "block_pattern": ["attn"],
           "parallel_block": False, "capacity_factor": 1.25, "tie_embeddings": False,
           "dtype": "bfloat16"}


def smoke_bench(tmp: Path, *, seq_len: int = 32, batch: int = 2,
                limits: dict | None = None, steps: int = 3) -> tuple[Path, Path]:
    """A root with ``BENCHMARK.json`` and a ``bench`` directory holding one
    cell a smoke configuration (``<config>.train``), the real metrics,
    roofline formulas and references.  Returns ``(root, bench)``."""
    root, bench = tmp, tmp / "bench"
    for sub in ("metrics", "roofline", "reference"):
        shutil.copytree(BENCH / sub, bench / sub, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "peaks.json", bench / "peaks.json")
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "traffic" / "train-s512.json").read_text())
    mix.update(batch=batch, seq_len=seq_len, pool=2, trace_steps=1)
    (bench / "traffic" / "smoke.json").write_text(json.dumps(mix))
    configs, cells = [], []
    for name, (port, model) in SMOKE_MODELS.items():
        cfg = {"name": name, "source": "https://example.org/smoke", "port_config": port,
               "reference": "decoder", "model": {**_COMMON, **model}, "reduced": []}
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": cfg["source"],
                        "file": f"bench/configs/{name}.json", "reduced": [], "why": "smoke"})
        cell = f"{name}.train"
        cells.append({"name": cell, "config": name, "traffic": "smoke", "chips": 1,
                      "why": "smoke"})
        lim = {"steps": steps, "limits": limits or SMOKE_LIMITS[name]}
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    spec = {**real, "configs": configs, "workloads": cells}
    spec["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                         for m in real["per_layer"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench
