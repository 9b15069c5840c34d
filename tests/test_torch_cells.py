"""The port's dry-run cells against the JAX package's ``launch/cells.py``:
the 40-cell matrix, ``skip_reason``, and ``plan_for`` for every arch x
shape on the production meshes at the same HBM budget; and the dry-run
CLI at ``--smoke --device cpu`` writing a record with every field."""
import json

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import cells as jcells
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells
from repro_torch.launch.mesh import describe_mesh, make_production_mesh


def test_cell_matrix_and_skip_reasons_match_reference():
    got = cells.cell_matrix()
    want = jcells.cell_matrix()
    assert len(got) == len(want) == 40
    canon = sorted((a.replace("_", "-"), s) for a, s in want)
    assert sorted(got) == canon
    for arch, shape in got:
        assert (cells.skip_reason(arch, shape) is None) == (
            jcells.skip_reason(arch, shape) is None), (arch, shape)
    assert sum(cells.skip_reason(a, s) is not None for a, s in got) == 7


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted({a for a, _ in cells.cell_matrix()}))
def test_plan_for_matches_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for budget in (cells.HBM_BUDGET, 12e9):
        for name in SHAPES:
            got = cells.plan_for(get_config(arch), SHAPES[name], mesh, hbm_budget=budget)
            want = jcells.plan_for(j_get_config(arch), J_SHAPES[name], mesh, hbm_budget=budget)
            assert (got.microbatches, got.seq_shard, got.remat, got.fsdp) == (
                want.microbatches, want.seq_shard, want.remat, want.fsdp), (name, budget)
    assert cells.HBM_BUDGET == 0.75 * 80e9


def test_production_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("data", "model") and pod.size == 256
    assert describe_mesh(pod) == "data=32 x model=8"
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert pod.devices.tolist() == np.arange(256).reshape(32, 8).tolist()


def test_dryrun_cli_writes_a_full_record(tmp_path):
    from repro_torch.launch import dryrun

    out = tmp_path / "dryrun.json"
    rc = dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--mesh", "pod", "--smoke",
                      "--device", "cpu", "--out", str(out)])
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["kind"] == "train"
    for key in ("microbatches", "seq_shard", "fsdp", "trace_s", "bytes_per_device",
                "arg_bytes", "fits_hbm", "flops_per_dev", "kernel_calls", "note", "roofline",
                "graphi"):
        assert key in rec, key
    rf = rec["roofline"]
    for key in ("flops", "bytes", "collective_bytes", "collectives", "compute_s", "memory_s",
                "collective_s", "bound_s", "dominant", "model_flops_total", "useful_ratio",
                "roofline_fraction", "mfu_bound"):
        assert key in rf, key
    assert rf["collective_bytes"] > 0 and rf["flops"] > 0 and rf["compute_s"] > 0
    gr = rec["graphi"]
    for key in ("n_nodes", "width", "n_executors", "team_size", "policy", "sim_makespan_s",
                "critical_path_s", "critical_path_ops"):
        assert key in gr, key
    assert rec["fits_hbm"] and 0 < rec["bytes_per_device"] < 80e9
    assert "fake process group" in rec["note"]


def test_dryrun_marks_skipped_and_refuses_run_on_the_cpu(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("gemma-2b", "long_500k", make_production_mesh(), smoke=True,
                          device="cpu")
    assert rec["status"] == "skip" and "full-attention" in rec["reason"]
    with pytest.raises(SystemExit, match="on the card"):
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--device", "cpu", "--run",
                     "--out", str(tmp_path / "x.json")])
