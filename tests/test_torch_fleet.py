"""The port's serving fleet (``repro_torch.fleet``) on the CPU.

Twins of ``tests/test_fleet.py``'s fifteen tests on the port's fleet (toy
workers: no torch in the children); parity with the JAX package's fleet in
the same process (the toy next-token function, the router, the fault
injector's victims and a whole toy fleet, with and without a kill); the
real-engine adapter — two replicas of the port's continuous or paged engine
at smoke size in f32 through a seeded kill, every stream held to an
in-process port engine; and the serving CLI's ``--replicas 2`` in toy,
continuous and paged modes.
"""
import random
import time

import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro.fleet import worker as ref_worker
from repro_torch.fleet import (Fleet, FleetConfig, FaultInjector, FaultSpec, Router,
                               corrupt_lease_release)
from repro_torch.fleet.worker import ToyEngine, build_engine, toy_next_token

VOCAB = 101


def toy_cfg(n_workers, *, service=0.002, hb=0.05, inflight=3, **kw):
    return FleetConfig(
        n_workers=n_workers,
        engine={"kind": "toy", "vocab_size": VOCAB, "service_time_s": service},
        heartbeat_s=hb, max_inflight_per_worker=inflight, term_grace_s=0.3,
        **kw)


def reference(prompt, n):
    out = []
    for _ in range(n):
        out.append(toy_next_token(prompt, out, VOCAB, seed=0))
    return out


def assert_exact(done):
    for r in done:
        assert list(r.tokens) == reference(r.prompt, r.max_new), \
            f"request {r.rid} diverged after {r.n_requeues} requeue(s)"


# ---------------------------------------------------------------------------
# components (twins of tests/test_fleet.py)
# ---------------------------------------------------------------------------

def test_toy_engine_resume_is_bit_exact():
    """Decoding 10 tokens straight == decoding 4, then resuming a fresh
    engine with those 4 as ``emitted`` — the replay contract in miniature."""
    e1 = ToyEngine(vocab_size=VOCAB)
    e1.submit(0, (3, 1, 4), 10)
    full = []
    while e1.has_work:
        full += [t for _, t, _, _ in e1.step()]

    e2 = ToyEngine(vocab_size=VOCAB)
    e2.submit(0, (3, 1, 4), 10, emitted=full[:4])
    resumed = list(full[:4])
    while e2.has_work:
        for _, tok, idx, _ in e2.step():
            assert idx == len(resumed)
            resumed.append(tok)
    assert resumed == full == reference((3, 1, 4), 10)


def test_router_prefers_affinity_then_load():
    r = Router(affinity_len=4, max_load_gap=2)
    for w in (0, 1, 2):
        r.add_worker(w)
    cap = {0: 4, 1: 4, 2: 4}
    prompt = (7, 7, 7, 7, 9)
    first = r.pick(prompt, capacity=cap)
    assert first == 0                      # all empty: lowest id wins
    # same prefix routes back to the same worker (affinity hit)
    assert r.pick((7, 7, 7, 7, 1), capacity=cap) == first
    assert r.n_affinity_hits == 1
    # a different prefix goes to the least-loaded worker, not worker 0
    assert r.pick((8, 8, 8, 8), capacity=cap) == 1
    # affinity yields once the load gap exceeds max_load_gap
    for _ in range(3):
        r.pick(prompt, capacity=cap)       # pile onto worker 0 (load 5)
    assert r.pick((7, 7, 7, 7, 2), capacity={0: 1, 1: 4, 2: 4}) != 0


def test_router_full_fleet_returns_none_and_forgets_dead_workers():
    r = Router()
    r.add_worker(0)
    assert r.pick((1, 2), capacity={0: 0}) is None
    assert r.pick((1, 2), capacity={0: 1}) == 0
    r.remove_worker(0)
    assert r.pick((1, 2), capacity={0: 3}) is None   # dead: not routable


# ---------------------------------------------------------------------------
# healthy-fleet behaviour
# ---------------------------------------------------------------------------

def test_fleet_drains_bit_exact_and_in_submit_order():
    reqs = [([i, i + 1], 8) for i in range(7)]
    with Fleet(toy_cfg(2)) as fleet:
        done = fleet.run(reqs, timeout_s=60)
        stats = fleet.stats()
    assert [r.rid for r in done] == sorted(r.rid for r in done)
    assert len(done) == 7
    assert_exact(done)
    assert stats["n_failovers"] == 0
    assert stats["router_routed"] == 7


def test_fleet_streams_tokens_in_order():
    seen: dict[int, list] = {}
    with Fleet(toy_cfg(2)) as fleet:
        fleet.on_token = lambda rid, tok, idx: seen.setdefault(rid, []).append(
            (idx, tok))
        done = fleet.run([([1, 2, 3], 6), ([4, 5], 6)], timeout_s=60)
    for r in done:
        assert [i for i, _ in seen[r.rid]] == list(range(r.max_new))
        assert [t for _, t in seen[r.rid]] == list(r.tokens)


def test_fleet_same_prompt_hits_same_replica():
    prompt = [9] * 20
    with Fleet(toy_cfg(2, inflight=8)) as fleet:
        fleet.run([(prompt, 4) for _ in range(6)], timeout_s=60)
        stats = fleet.stats()
    assert stats["router_affinity_hits"] >= 5


# ---------------------------------------------------------------------------
# fault drills
# ---------------------------------------------------------------------------

@pytest.mark.stress
@pytest.mark.parametrize("kind", ["kill", "die", "stall", "mute"])
def test_fleet_failover_zero_loss_bit_exact(kind):
    """The drill: kill/wedge/mute a replica mid-decode; every request still
    completes with a bit-identical stream."""
    reqs = [([i, i + 2], 16) for i in range(8)]
    with Fleet(toy_cfg(4, inflight=2)) as fleet:
        inj = FaultInjector(
            [FaultSpec(kind=kind, at_tokens=12, duration_s=5.0)], seed=3)
        done = fleet.run(reqs, injector=inj, timeout_s=120)
        stats = fleet.stats()
    assert len(done) == len(reqs), "lost requests across failover"
    assert_exact(done)
    assert inj.all_fired
    assert stats["n_failovers"] >= 1
    assert stats["n_requeued"] >= 1
    assert stats["n_restarts"] >= 1


@pytest.mark.stress
def test_fleet_survives_two_sequential_kills():
    reqs = [([i], 20) for i in range(8)]
    with Fleet(toy_cfg(3, inflight=3, max_restarts=4)) as fleet:
        inj = FaultInjector([FaultSpec(kind="kill", at_tokens=20),
                             FaultSpec(kind="kill", at_tokens=80)], seed=11)
        done = fleet.run(reqs, injector=inj, timeout_s=120)
        stats = fleet.stats()
    assert len(done) == len(reqs)
    assert_exact(done)
    assert stats["n_failovers"] == 2
    # the killed slots respawned with bumped generations
    assert sum(stats["generations"].values()) == 2


@pytest.mark.stress
def test_fleet_short_mute_flushes_buffered_stream():
    """A mute shorter than the liveness deadline must NOT fail the worker:
    the buffered tokens flush in order and indices stay contiguous."""
    cfg = toy_cfg(1, inflight=4, liveness_s=2.0)
    with Fleet(cfg) as fleet:
        inj = FaultInjector(
            [FaultSpec(kind="mute", at_tokens=4, duration_s=0.3)], seed=0)
        done = fleet.run([([1, 2], 24), ([3, 4], 24)], injector=inj,
                         timeout_s=60)
        stats = fleet.stats()
    assert stats["n_failovers"] == 0
    assert len(done) == 2
    assert_exact(done)


@pytest.mark.stress
def test_fleet_wedge_is_detected_by_silence():
    """A stalled serve loop sends no heartbeats; the liveness deadline —
    not a crash — must trigger the failover."""
    reqs = [([i, i], 16) for i in range(4)]
    with Fleet(toy_cfg(2, inflight=2)) as fleet:
        inj = FaultInjector(
            [FaultSpec(kind="stall", at_tokens=8, duration_s=10.0)], seed=5)
        t0 = time.monotonic()
        done = fleet.run(reqs, injector=inj, timeout_s=120)
        wall = time.monotonic() - t0
        events = list(fleet.events)
    assert len(done) == len(reqs)
    assert_exact(done)
    fails = [(t, why) for t, kind, _, why in events if kind == "fail"]
    assert fails and "silent" in fails[0][1]
    assert wall < 10.0, "drain waited for the stall instead of failing over"


def test_fleet_restart_budget_exhaustion_raises():
    with pytest.raises(RuntimeError, match="restart budget"):
        with Fleet(toy_cfg(1, max_restarts=0)) as fleet:
            fleet.submit([1, 2], 50)
            inj = FaultInjector([FaultSpec(kind="kill", at_tokens=2)], seed=0)
            fleet.run(timeout_s=60, injector=inj)


# ---------------------------------------------------------------------------
# runtime-level fault: corrupted lease release (the port's Runtime)
# ---------------------------------------------------------------------------

def test_corrupt_lease_release_is_absorbed():
    import repro_torch

    rt = repro_torch.Runtime(3, device="cpu")
    try:
        health = corrupt_lease_release(rt, width=2)
        assert health["bad_releases"] >= 2        # double + stale release
        assert health["free"] == 3                # free list intact
        lease = rt.lease(3)                       # full width still grantable
        lease.release()
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# parity with the JAX package's fleet, in one process
# ---------------------------------------------------------------------------

def test_toy_next_token_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        vocab = int(rng.integers(2, 70000))
        seed = int(rng.integers(0, 2**33))
        prompt = [int(x) for x in rng.integers(0, 2**31, size=int(rng.integers(0, 40)))]
        emitted = [int(x) for x in rng.integers(0, vocab, size=int(rng.integers(0, 20)))]
        assert toy_next_token(prompt, emitted, vocab, seed=seed) == \
            ref_worker.toy_next_token(prompt, emitted, vocab, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_equals_the_reference(seed):
    """A seeded sequence of add / remove / note_done / pick calls gives the
    same picks and affinity hits on both routers."""
    rng = random.Random(seed)
    ours = Router(affinity_len=4, max_load_gap=2)
    ref = ref_fleet.Router(affinity_len=4, max_load_gap=2)
    live: set[int] = set()
    picks = []
    for _ in range(400):
        op = rng.random()
        if op < 0.1:
            w = rng.randrange(6)
            ours.add_worker(w)
            ref.add_worker(w)
            live.add(w)
        elif op < 0.15:
            w = rng.randrange(6)
            ours.remove_worker(w)
            ref.remove_worker(w)
            live.discard(w)
        elif op < 0.35:
            w = rng.randrange(6)
            ours.note_done(w)
            ref.note_done(w)
        else:
            prompt = tuple(rng.randrange(3) for _ in range(rng.randrange(1, 8)))
            cap = {w: rng.randrange(0, 4) for w in range(6)}
            a, b = ours.pick(prompt, capacity=cap), ref.pick(prompt, capacity=cap)
            assert a == b
            picks.append(a)
    assert ours.n_affinity_hits == ref.n_affinity_hits > 0
    assert ours.n_routed == ref.n_routed
    assert any(p is not None for p in picks) and None in picks


class _StubWorker:
    def __init__(self, wid):
        self.wid = wid
        self.inflight = {}


class _StubFleet:
    """What the injector reads and calls of a fleet, recording the calls."""

    def __init__(self, n):
        self._workers = {w: _StubWorker(w) for w in range(n)}
        self.on_token = None
        self.calls = []

    def kill_worker(self, wid):
        self.calls.append(("kill", wid))

    def send_fault(self, wid, msg):
        self.calls.append((msg["type"], wid, msg.get("seconds")))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_injector_equals_the_reference(seed):
    """Same specs and seed, same stub fleet states: the same victims, calls
    and log on both packages."""
    kinds = ["kill", "die", "stall", "mute", "kill", "stall"]
    fleets = []
    for mod in (None, ref_fleet):
        spec_cls = FaultSpec if mod is None else mod.FaultSpec
        inj_cls = FaultInjector if mod is None else mod.FaultInjector
        specs = [spec_cls(kind=k, at_tokens=5 * i, duration_s=0.5 + i,
                          worker=2 if i == 4 else None)
                 for i, k in enumerate(kinds)]
        inj = inj_cls(specs, seed=seed)
        fl = _StubFleet(4)
        rng = random.Random(seed)
        for step in range(40):
            for w in fl._workers.values():      # the same busy sets each step
                w.inflight = {r: None for r in range(rng.randrange(3))}
            inj.tick(fl)
            fl.on_token(step, 1, step)
        fleets.append((inj.log, fl.calls, inj.all_fired))
    assert fleets[0] == fleets[1]
    assert fleets[0][2] and len(fleets[0][0]) == len(kinds)


@pytest.mark.parametrize("fault", [None, "kill"])
def test_toy_fleet_equals_the_reference(fault):
    """A toy fleet of the port and one of the reference serve the same 12
    requests (with and without a seeded kill) to the same streams, each the
    pure reference's."""
    reqs = [([i, 3 * i + 1, 7], 10) for i in range(12)]
    streams = []
    for mod in (None, ref_fleet):
        fleet_cls = Fleet if mod is None else mod.Fleet
        cfg_cls = FleetConfig if mod is None else mod.FleetConfig
        cfg = cfg_cls(n_workers=3, engine={"kind": "toy", "vocab_size": VOCAB,
                                           "service_time_s": 0.002},
                      heartbeat_s=0.05, max_inflight_per_worker=2, term_grace_s=0.3)
        injector = None
        if fault:
            spec_cls = FaultSpec if mod is None else mod.FaultSpec
            inj_cls = FaultInjector if mod is None else mod.FaultInjector
            injector = inj_cls([spec_cls(kind=fault, at_tokens=15)], seed=7)
        with fleet_cls(cfg) as fleet:
            done = fleet.run(reqs, injector=injector, timeout_s=120)
            stats = fleet.stats()
        assert stats["n_failovers"] == (1 if fault else 0)
        streams.append([(r.rid, list(r.prompt), list(r.tokens)) for r in done])
    assert streams[0] == streams[1]
    assert len(streams[0]) == 12
    for _, prompt, toks in streams[0]:
        assert toks == reference(prompt, 10)


# ---------------------------------------------------------------------------
# the real-engine adapter on the CPU: two port engines through a kill
# ---------------------------------------------------------------------------

REAL_MAX_NEW = 6
REAL_PROMPT_LENS = (8, 19, 11, 19)


def real_prompts():
    rng = np.random.default_rng(5)
    return [[int(x) for x in rng.integers(1, 512, size=n)] for n in REAL_PROMPT_LENS]


# f32, and an untied output head: with gemma's tied embeddings, random
# weights make every stream repeat its prompt's last token, so a replay that
# lost or misplaced its emitted tokens would still pass
OVERRIDES = {"dtype": "float32", "tie_embeddings": False}


def real_spec(kind):
    return {"kind": kind, "arch": "gemma-2b", "smoke": True, "device": "cpu",
            "overrides": OVERRIDES, "max_batch": 2,
            "max_len": max(REAL_PROMPT_LENS) + REAL_MAX_NEW + 1,
            "engine_kwargs": {"max_executors": 2}}


@pytest.fixture(scope="module", params=["continuous", "paged"])
def real_fleet(request):
    """One fleet a kind, shared by the asserts below: 2 replicas, 4 requests;
    once every request has streamed a token, a seeded kill of a busy
    replica (so each replayed request resumes after emitted tokens), then
    the respawn awaited."""
    kind = request.param
    cfg = FleetConfig(n_workers=2, engine=real_spec(kind), heartbeat_s=0.5,
                      liveness_s=120.0, startup_grace_s=300.0,
                      max_inflight_per_worker=2, term_grace_s=2.0)
    with Fleet(cfg) as fleet:
        rids = [fleet.submit(p, REAL_MAX_NEW) for p in real_prompts()]
        deadline = time.monotonic() + 300
        while not all(fleet._requests[rid].tokens for rid in rids):
            assert time.monotonic() < deadline, "no first tokens in time"
            fleet.pump()
        before = {rid: len(fleet._requests[rid].tokens) for rid in rids}
        inj = FaultInjector([FaultSpec(kind="kill", at_tokens=0)], seed=0)
        inj.tick(fleet)
        done = fleet.run(timeout_s=300)
        fleet.wait_ready(timeout_s=300)
        out = {"kind": kind, "done": done, "stats": fleet.stats(), "log": inj.log,
               "boots": list(fleet.boots), "before_kill": before}
    return out


def in_process_streams(kind):
    """Greedy streams of an in-process port engine of the same kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve.engine import ContinuousEngine, Request, ServeConfig
    from repro_torch.serve.paged import PagedConfig, PagedEngine

    spec = real_spec(kind)
    cfg = get_config("gemma-2b", smoke=True).reduced(dtype=torch.float32,
                                                     tie_embeddings=False)
    params = transformer.init_params(cfg, 0, device="cpu")
    scfg = ServeConfig(max_batch=2, max_len=spec["max_len"], temperature=0.0)
    rt = Runtime(device="cpu")
    try:
        if kind == "paged":
            eng = PagedEngine(cfg, params, scfg, paged=PagedConfig(), device="cpu",
                              runtime=rt, max_executors=2)
        else:
            eng = ContinuousEngine(cfg, params, scfg, device="cpu", runtime=rt,
                                   max_executors=2)
        for i, p in enumerate(real_prompts()):
            eng.submit(Request(request_id=i, prompt=np.asarray(p, np.int32),
                               max_new_tokens=REAL_MAX_NEW))
        done = eng.run()
    finally:
        rt.close()
    return cfg, params, {r.request_id: list(r.output) for r in done}


def top_two_gap(cfg, params, prompt, tokens, index):
    """The uninterrupted greedy run's gap between its two largest logits at
    ``index`` (eager prefill of the prompt, then decode steps of ``tokens``)."""
    from repro_torch.models import transformer
    from repro_torch.serve.step import mask_pad_vocab

    cache = transformer.init_cache(cfg, 1, len(prompt) + len(tokens) + 1, device="cpu")
    toks = torch.as_tensor(np.asarray([prompt], np.int32))
    logits, cache = transformer.prefill(cfg, params, {"tokens": toks}, cache)
    for t in tokens[:index]:
        logits, cache = transformer.decode_step(
            cfg, params, torch.as_tensor([[t]], dtype=torch.int32), cache)
    top = torch.topk(mask_pad_vocab(logits, cfg.vocab_size)[0].float(), 2).values
    return float(top[0] - top[1])


def test_real_adapter_streams_are_whole_and_in_vocab(real_fleet):
    done = real_fleet["done"]
    assert len(done) == len(REAL_PROMPT_LENS), "lost requests across failover"
    for r in done:
        assert len(r.tokens) == REAL_MAX_NEW and r.done
        assert all(0 <= t < 512 for t in r.tokens)
    # the supervisor asserted every index contiguous as it arrived; each
    # replayed request resumed after the tokens it had streamed
    assert any(r.n_requeues for r in done)
    assert all(real_fleet["before_kill"][r.rid] >= 1 for r in done)


def test_real_adapter_fails_over_once_and_the_respawn_serves(real_fleet):
    stats, boots = real_fleet["stats"], real_fleet["boots"]
    assert real_fleet["log"] and real_fleet["log"][0][0] == "kill"
    assert stats["n_failovers"] == 1 and stats["n_restarts"] == 1
    assert stats["n_requeued"] >= 1
    victim = real_fleet["log"][0][1]
    assert stats["generations"][victim] == 1
    assert sorted((b["wid"], b["generation"]) for b in boots) == \
        sorted([(0, 0), (1, 0), (victim, 1)])
    for b in boots:          # each boot reports its engine's set-up phases
        assert b["boot_s"] > 0 and {"decode_capture", "decode_calibrate"} <= set(b["setup_s"])


def test_real_adapter_streams_equal_an_in_process_engine(real_fleet):
    """Each stream equals the in-process engine's greedy stream; a replayed
    stream (``prompt + emitted`` prefilled anew) may differ only where the
    uninterrupted run's two largest logits lie within 1e-5 (an f32 tie)."""
    cfg, params, want = in_process_streams(real_fleet["kind"])
    for r in real_fleet["done"]:
        got, ref = list(r.tokens), want[r.rid]
        if got == ref:
            continue
        assert r.n_requeues, f"request {r.rid} was never failed over and differs"
        first = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        gap = top_two_gap(cfg, params, list(r.prompt), ref, first)
        assert gap <= 1e-5, (f"replayed request {r.rid} differs at index {first} "
                             f"where the top two logits are {gap:.3e} apart")


def test_a_real_worker_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine({"kind": "continuous", "arch": "gemma-2b", "smoke": True})


# ---------------------------------------------------------------------------
# the serving CLI with --replicas 2
# ---------------------------------------------------------------------------

CLI = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--requests", "4",
       "--prompt-len", "8,19", "--max-new", "5", "--max-batch", "2", "--replicas", "2"]


@pytest.mark.parametrize("mode,kind", [(["--replica-engine", "toy"], "toy"),
                                       (["--continuous"], "continuous"),
                                       (["--paged"], "paged")])
def test_serve_cli_with_replicas(mode, kind, capsys):
    from repro_torch.launch import serve

    assert serve.main(CLI + mode) == 0
    out = capsys.readouterr().out
    assert f"[fleet:{kind} x2] served 4 requests, 20 tokens" in out
    assert "  failovers=0 requeued=0 affinity_hits=" in out


def test_bench_twin_recovery_and_shed_legs(tmp_path):
    """``scripts/torch_bench_fleet.py``'s recovery leg (a kill of one of 4
    toy replicas: nothing lost, every stream the pure reference's, the gap
    measured on one clock) and its shedding leg, at a small size."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_bench_fleet.py"
    spec = importlib.util.spec_from_file_location("torch_bench_fleet", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    args = SimpleNamespace(requests=12, max_new=8, rate=200.0, seed=0, real=False,
                           full=False, device="cpu", arch="gemma-2b",
                           calibration_store=str(tmp_path / "cal.json"))
    rec = bench.bench_recovery(args)
    assert rec["n_failovers"] == 1 and rec["n_requeued"] >= 1
    assert 0 <= rec["recovery_s"] < 10.0
    shed = bench.bench_shed(args)
    assert shed["accepted"] + shed["rejected"] == 24 and shed["accepted"] > 0
