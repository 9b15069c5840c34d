"""No module of JAX or of the JAX package in a run, compared by whole
top-level names: ``repro_torch`` passes although its name begins with
``repro``; ``repro``, ``jax``, ``jaxlib`` and ``flax`` do not."""
import json
import subprocess
import sys

from bench_smoke import BENCH, ROOT
from harness.check import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["repro_torch", "repro_torch.models.moe", "reprox", "jaxtyping",
                              "harness.check", "flax_like"]) == []
    assert forbidden_modules(["repro", "repro.core.graph", "jax", "jax.numpy", "jaxlib.xla",
                              "flax.linen", "repro_torch"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core.graph"]


_DRIVE = f"""
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{str(BENCH / 'tests')!r}]
from bench_smoke import smoke_bench
from harness import spec, train
root, bench = smoke_bench(Path(tempfile.mkdtemp()))
for name in ("h2o-smoke.train", "granite-smoke.train"):
    cell = spec.load_cell(name, root=root, bench=bench)
    train.run(cell, 3, 0.01, trace=False, t_start=0.0, device="cpu")
import run, calibrate, witness_embedding
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax_module(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE], capture_output=True, text=True,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                        "TMPDIR": str(tmp_path)}, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in modules and "harness.train" in modules
    assert forbidden_modules(modules) == []


def test_the_harness_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro ", "from repro.",
                    "import repro.", "import flax", "from flax"):
            assert bad not in text, (path, bad)
