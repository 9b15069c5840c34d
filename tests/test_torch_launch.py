"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the CPU:
every engine mode serves the smoke gemma-2b and prints its stats, greedy
streams agree across modes, and the options of the modules ported since the
CLI was (the fleet's ``--replicas``, ``--check``, ``--pinning``) are taken."""
import re

import pytest

from repro_torch.launch import serve

BASE = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--requests", "4",
        "--prompt-len", "8,19", "--max-new", "5", "--max-batch", "2"]


def _first_tokens(out: str) -> dict[int, str]:
    return dict((int(m.group(1)), m.group(2))
                for m in re.finditer(r"req (\d+): \d+ tokens, first 8 = (\[[^\]]*\])", out))


@pytest.fixture(scope="module")
def wave_tokens():
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert serve.main(BASE) == 0
    out = buf.getvalue()
    assert "[wave] served 4 requests, 20 tokens" in out
    return _first_tokens(out)


@pytest.mark.parametrize("mode", [["--continuous"], ["--continuous", "--decode-host-mode",
                                                     "dynamic", "--dump-trace", "csv"],
                                  ["--paged", "--page-size", "8", "--prefill-chunk", "8"],
                                  ["--continuous", "--arrival-rate", "200"]])
def test_each_mode_serves_and_matches_the_wave_engine(mode, wave_tokens, capsys):
    assert serve.main(BASE + mode) == 0
    out = capsys.readouterr().out
    name = "paged" if "--paged" in mode else "continuous"
    assert f"[{name}] served 4 requests, 20 tokens" in out
    assert "n_decode_steps=" in out
    if "--arrival-rate" not in mode:   # arrivals draw from the prompts' generator
        assert _first_tokens(out) == wave_tokens
    if "--dump-trace" in mode:
        assert "op,executor,start_us,end_us,duration_us" in out


def test_calibration_store_is_written(tmp_path, capsys):
    store = tmp_path / "cal.json"
    assert serve.main(BASE + ["--continuous", "--calibration-store", str(store)]) == 0
    assert store.exists() and store.stat().st_size > 0


@pytest.mark.parametrize("flags,item", [(["--replicas", "2", "--replica-engine", "toy"], "A14"),
                                        (["--check", "basic"], "A12"),
                                        (["--pinning", "auto"], "A13")])
def test_options_of_unported_modules_are_refused(flags, item, capsys):
    """The options of A14 (the serving fleet), A12 (the hazard checks) and
    A13 (hwperf), each refused until its module was ported, are taken and
    serve.  The name dates from before those ports and is kept so the cases
    keep their ids: every case checks acceptance, not refusal."""
    if item == "A14":
        assert serve.main(BASE + flags) == 0
        out = capsys.readouterr().out
        assert "[fleet:toy x2] served 4 requests, 20 tokens" in out
        assert "  failovers=0 requeued=0 affinity_hits=" in out
        return
    assert serve.main(BASE + ["--continuous"] + flags) == 0
    out = capsys.readouterr().out
    assert "[continuous] served 4 requests" in out
    if item == "A12":
        assert "check[basic]: 0 error(s)" in out


def test_helpers():
    from repro_torch.configs import get_config

    cfg = get_config("gemma-2b", smoke=True)
    arr = serve.build_requests(cfg, n_requests=5, prompt_lens=[3, 7], max_new=2,
                               arrival_rate=10.0)
    assert [len(r.prompt) for _, r in arr] == [3, 7, 3, 7, 3]
    times = [t for t, _ in arr]
    assert times == sorted(times) and times[0] > 0
    assert serve.percentile([], 0.5) == 0.0
    assert serve.percentile([3, 1, 2], 0.5) == 2
