"""The check catches the faults a training cell can have.  The whole run
is driven on the CPU at the smoke sizes (no look for a chip) with the
program's step broken underneath, and ``correct`` must come out false:

* a step that returns its state unchanged;
* half of the batch left out, the mean taken over the rest;
* a token altered where it is fed.

(One card: there is no exchange between chips to leave out.)  The control,
the reference one precision below put in the program's place, must come
out not correct as well.  Each is judged with the smoke cell's own limits
(``bench_smoke.SMOKE_LIMITS``), under which the unbroken run is correct.
The control is held here at the dense smoke size; at any MoE size a CPU
test can hold, the bf16 program's routing flips read as far from the
reference as the control does (64-wide routers, 64-512 tokens), so the
MoE cell's control readings are the chip's, beside its limits."""
import copy

import pytest
import torch

from bench_smoke import smoke_bench
from harness import check, spec, train


def _unchanged(step):
    def wrapped(state, batch):
        _, metrics = step(copy.deepcopy(state), batch)
        return state, metrics
    return wrapped


def _half_batch(step):
    def wrapped(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return wrapped


def _token_altered(step):
    def wrapped(state, batch):
        t = batch["tokens"].clone()
        t[:, 0] = (t[:, 0] + 1) % 512
        return step(state, {**batch, "tokens": t})
    return wrapped


NAMES = ["h2o-smoke.train", "granite-smoke.train"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return smoke_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _token_altered])
@pytest.mark.parametrize("name", NAMES)
def test_a_planted_fault_is_not_correct(bench, name, fault):
    root, b = bench
    cell = spec.load_cell(name, root=root, bench=b)
    r = train.run(cell, 1234567, 0.01, trace=False, t_start=0.0, device="cpu",
                  step_hook=fault)
    ok, shown = check.judge(r.numbers, cell.limits["limits"])
    assert not ok, shown


@pytest.mark.parametrize("name", NAMES)
def test_the_same_run_unbroken_is_correct(bench, name):
    root, b = bench
    cell = spec.load_cell(name, root=root, bench=b)
    r = train.run(cell, 1234567, 0.01, trace=False, t_start=0.0, device="cpu")
    ok, shown = check.judge(r.numbers, cell.limits["limits"])
    assert ok, shown


def test_an_unchanged_state_reads_one():
    ref = {"loss": [1.0], "grad": {("a",): 1.0, ("b",): 2.0},
           "raw_grad": {("a",): 1.0, ("b",): 2.0}, "change": {("a",): 0.5, ("b",): 0.7}}
    prog = {**ref, "change": {("a",): 0.0, ("b",): 0.0}}
    assert check.compare(prog, ref)["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["h2o-smoke.train"])
def test_the_control_is_not_correct(bench, name):
    from harness import traffic
    from harness.weights import Weights
    from reference.follow import follow

    root, b = bench
    cell = spec.load_cell(name, root=root, bench=b)
    model, mix = cell.config["model"], cell.traffic
    ref = spec.reference(cell.config, b)
    w = Weights(ref.layout(model), 99, "cpu")
    first = traffic.batches(mix, model["vocab_size"], 99, range(cell.limits["steps"]), "cpu")
    base = follow(ref, model, w.flat(w.make()), first, mix["optimizer"], initial=w.initial)
    control = follow(ref, model, w.flat(w.make()), first, mix["optimizer"], precision="fp8",
                     initial=w.initial)
    ok, shown = check.judge(check.compare(control, base), cell.limits["limits"])
    assert not ok, shown
    assert torch.float8_e4m3fn is not None
