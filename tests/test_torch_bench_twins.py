"""The serving bench twins of the PyTorch port (``scripts/torch_bench_*.py``)
and its examples (``examples/torch_*.py``) on the CPU at tiny sizes
(``--device cpu``): each twin's building blocks, the keys of the JSON it
writes, and the gates that are not timings (token parity across engines,
prefix sharing, the oracle checks, the schedule search).  The speed gates
compare wall times and are not asserted here: the tests share the host
with other workers."""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _not_speed(gates) -> list:
    return [(kind, holds, msg) for kind, holds, msg in gates if kind != "speed"]


def test_serve_twin_payload_and_parity(tmp_path):
    twin = _load("scripts/torch_bench_serve.py")
    args = twin.parser().parse_args(["--device", "cpu", "--requests", "6", "--max-new", "4",
                                     "--prompt-lens", "4,12", "--arrival-rate", "0",
                                     "--out", str(tmp_path / "b.json")])
    payload, done = twin.run(args)
    assert set(payload) == {"total_wall_s", "device", "workload", "rows"}
    assert payload["device"] == {"type": "cpu", "name": "cpu"}
    assert payload["workload"]["vocab_size"] == 300 < payload["workload"]["padded_vocab"]
    wave, cont = payload["rows"]
    assert (wave["bench"], cont["bench"]) == ("serve_wave", "serve_continuous")
    for row in (wave, cont):
        assert row["n_requests"] == 6 and row["n_tokens"] == 24
        assert {"tok_per_s", "lat_p50_ms", "lat_p95_ms", "max_token_id"} <= set(row)
    assert {"n_decode_steps", "n_overlapped_prefills", "n_executors",
            "profiled_config"} <= set(cont)
    checks = _not_speed(twin.gates(payload, done))
    assert len(checks) == 3 and all(holds for _, holds, _ in checks), checks


def test_serve_twins_write_their_json_before_the_gates(tmp_path, monkeypatch):
    twin = _load("scripts/torch_bench_serve.py")
    out = tmp_path / "b.json"
    monkeypatch.setattr(twin, "gates", lambda payload, done: [("speed", False, "slow")])
    with pytest.raises(SystemExit, match="GATE FAILED: slow"):
        twin.main(["--device", "cpu", "--requests", "2", "--max-new", "2", "--prompt-lens",
                   "4", "--arrival-rate", "0", "--out", str(out)])
    assert json.loads(out.read_text())["rows"][0]["bench"] == "serve_wave"


def test_paged_twin_payload_parity_and_memory(tmp_path):
    twin = _load("scripts/torch_bench_serve_paged.py")
    args = twin.parser().parse_args([
        "--device", "cpu", "--requests", "6", "--max-new", "2", "--legs", "1",
        "--system-len", "64", "--page-size", "8", "--prefill-chunk", "8", "--d-model", "64",
        "--out", str(tmp_path / "p.json")])
    payload, done = twin.run(args)
    assert set(payload) == {"total_wall_s", "device", "workload", "rows", "admission"}
    paged, cont = payload["rows"]
    assert (paged["bench"], cont["bench"]) == ("serve_paged", "serve_per_slot")
    assert {"n_shared_pages", "peak_pages", "peak_kv_bytes", "legs"} <= set(paged)
    assert set(payload["admission"]) == {"short_only_p95_ms", "with_long_p95_ms",
                                         "long_prompt_len"}
    checks = _not_speed(twin.gates(payload, done))
    assert [k for k, _, _ in checks] == ["parity", "parity", "memory"]
    assert all(holds for _, holds, _ in checks), checks


def test_sched_twin_payload_oracles_and_search():
    twin = _load("scripts/torch_bench_sched_overhead.py")
    args = twin.parser().parse_args(["--device", "cpu", "--repeats", "3", "--steps", "2",
                                     "--executors", "2"])
    payload = twin.run(args)
    assert set(payload) == {"total_wall_s", "device", "rows", "schedule_search"}
    assert payload["device"]["hw_model"] == "knl7250"
    micro, step, strict = payload["rows"]
    assert [r["bench"] for r in payload["rows"]] == ["decode_micro", "serve_decode_step",
                                                     "strict_check_overhead"]
    assert micro["n_ops"] > 0 and step["n_nodes"] > 0 and strict["n_nodes"] > 0
    search = payload["schedule_search"]
    assert set(search["families"]) == {"gemma-2b", "olmoe-1b-7b"}
    checks = _not_speed(twin.gates(payload))
    assert len(checks) == 6 and all(holds for _, holds, _ in checks), checks


def test_quickstart_twin_matches_the_direct_call():
    assert _load("examples/torch_quickstart.py").main(["--device", "cpu"]) < 1e-5


def test_serve_decode_twin_serves_every_request():
    done = _load("examples/torch_serve_decode.py").main(["--device", "cpu", "--requests", "3",
                                                         "--arch", "h2o-danube3-4b"])
    assert [r.request_id for r in done] == [0, 1, 2] and all(r.output for r in done)
