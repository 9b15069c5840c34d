"""The harness finds cells, configurations, mixes, limits and metrics by
name; a new cell, configuration, mix and metric are new files and entries,
picked up without an edit.  And ``BENCHMARK.json`` keeps the contract's
shape."""
import json
import re

from bench_smoke import BENCH, ROOT, smoke_bench
from harness import spec, train

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_resolves_with_its_files_and_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits["limits"]) <= {"loss_gap", "loss1_gap", "grad_gap",
                                              "grad_median_gap", "change_gap",
                                              "change_median_gap"}
        assert cell.limits["limits"]
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
        assert callable(spec.reference(cell.config).loss_and_grads)


def test_benchmark_json_keeps_the_contract_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"] and bench["command"] == ["python3", "bench/run.py"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(_NAME.match(n) for n in names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, f"PERF.md's list of layers lacks {layer!r}"
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_config_files_match_the_port_configs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        train.port_config(cfg)          # raises on any size that differs
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path):
    root, bench = smoke_bench(tmp_path)
    # a new configuration, mix, limits and metric, and a cell naming them
    cfg = json.loads((bench / "configs" / "h2o-smoke.json").read_text())
    cfg["name"] = "h2o-smoke-wide"
    (bench / "configs" / "h2o-smoke-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "smoke.json").read_text())
    mix.update(seq_len=16, tokens={"law": "uniform"})
    (bench / "traffic" / "short-uniform.json").write_text(json.dumps(mix))
    (bench / "limits" / "h2o-smoke-wide.short-uniform.json").write_text(json.dumps(
        {"steps": 2, "limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.window['steps'])\n")
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "h2o-smoke-wide", "source": "https://example.org",
                                 "file": "bench/configs/h2o-smoke-wide.json", "reduced": [],
                                 "why": "test"})
    spec_json["workloads"].append({"name": "h2o-smoke-wide.short-uniform",
                                   "config": "h2o-smoke-wide", "traffic": "short-uniform",
                                   "chips": 1, "why": "test"})
    spec_json["per_layer"].append({"name": "steps_in_window", "unit": "count",
                                   "better": "higher", "source": "host_clock",
                                   "layer": "train step", "moves": "train_tokens_per_s",
                                   "workloads": ["h2o-smoke-wide.short-uniform"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))

    cell = spec.load_cell("h2o-smoke-wide.short-uniform", root=root, bench=bench)
    assert cell.traffic["seq_len"] == 16 and cell.limits["steps"] == 2
    assert "steps_in_window" in [m["name"] for m in cell.per_layer]
    other = spec.load_cell("h2o-smoke.train", root=root, bench=bench)
    assert "steps_in_window" not in [m["name"] for m in other.per_layer]

    r = train.run(cell, 7, 0.01, trace=False, t_start=0.0, device="cpu")
    ctx = train.context(r, None)
    assert spec.metric_reader("steps_in_window", bench).read(ctx) == r.window["steps"] >= 1
    assert len(r.program["loss"]) == 2 and r.window["tokens"] == r.window["steps"] * 2 * 16


def test_a_name_is_checked_before_a_file_is_read(tmp_path):
    root, bench = smoke_bench(tmp_path)
    try:
        spec.metric_reader("../../etc/passwd", bench)
    except ValueError:
        pass
    else:
        raise AssertionError("a path was taken for a metric's name")
    assert BENCH.name == "bench"
