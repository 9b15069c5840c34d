"""On the card: one short run of the smallest cell through ``bench/run.py``
prints the contract's last line.  Skips without a CUDA device (decided in
the test)."""
import json
import subprocess
import sys

import pytest

from bench_smoke import ROOT


@pytest.mark.gpu
def test_a_short_run_prints_the_result_line(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "h2o-danube3-4b.train-s512", "--seed", str(2 ** 32 + 9),
                          "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check" and line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert "attention_roofline.train" in line["metrics"]
    assert 0 < line["metrics"]["attention_roofline.train"]["value"] <= 100
