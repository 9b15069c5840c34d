"""The plain reference against the port on the CPU, at the smoke
configurations: with both in float32 the loss and every gradient agree to
rounding; with the port in its bfloat16, a run of the harness judges it
correct; and the traffic and weights are functions of the seed."""
import math

import pytest
import torch
from torch.utils import _pytree as pytree

from bench_smoke import smoke_bench
from harness import spec, train, traffic
from harness.weights import Weights, keystr


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return smoke_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["h2o-smoke.train", "granite-smoke.train"])
def test_reference_matches_the_port_in_float32(bench, name):
    from repro_torch.models import api as model_api
    from repro_torch.models import transformer
    from repro_torch.train.step import value_and_grad

    root, b = bench
    cell = spec.load_cell(name, root=root, bench=b)
    model = cell.config["model"]
    ref = spec.reference(cell.config, b)
    cfg = train.port_config(cell.config).reduced(dtype=torch.float32)
    w = Weights(ref.layout(model), 11, "cpu")
    bufs = w.make()
    params = pytree.tree_map(lambda t: t.float(), w.tree(bufs))
    batch = traffic.batches(cell.traffic, model["vocab_size"], 11, range(1), "cpu")[0]

    def loss_fn(p, bt):
        return model_api.lm_loss(cfg, p, bt, remat=False)[0]

    loss, grads = value_and_grad(loss_fn, unread=transformer.unread_params(cfg))(params, batch)
    r_loss, r_grads, _ = ref.loss_and_grads(model, {k: v.float() for k, v in
                                                    w.flat(bufs).items()}, batch)
    assert math.isclose(float(loss), r_loss, rel_tol=1e-5)
    by_key = {keystr(p): g for p, g in r_grads.items()}
    for kp, g in pytree.tree_flatten_with_path(grads)[0]:
        want = by_key[pytree.keystr(kp)]
        scale = float(want.abs().max()) + 1e-12
        assert float((g - want).abs().max()) <= 2e-4 * scale, pytree.keystr(kp)


@pytest.mark.parametrize("name", ["h2o-smoke.train", "granite-smoke.train"])
def test_a_cpu_run_of_the_port_in_bfloat16_is_judged_correct(bench, name):
    from harness import check

    root, b = bench
    cell = spec.load_cell(name, root=root, bench=b)
    r = train.run(cell, 2 ** 33 + 5, 0.01, trace=False, t_start=0.0, device="cpu")
    ok, shown = check.judge(r.numbers, cell.limits["limits"])
    assert ok, shown
    assert len(r.program["loss"]) == len(r.reference["loss"]) == 3
    assert r.window["steps"] >= 1


def test_batches_are_a_function_of_the_seed(bench):
    root, b = bench
    cell = spec.load_cell("h2o-smoke.train", root=root, bench=b)
    big = 2 ** 31 + 12345
    one = traffic.batches(cell.traffic, 512, big, range(3), "cpu")
    two = traffic.batches(cell.traffic, 512, big, range(3), "cpu")
    other = traffic.batches(cell.traffic, 512, big + 1, range(3), "cpu")
    for x, y, z in zip(one, two, other):
        assert torch.equal(x["tokens"], y["tokens"]) and not torch.equal(x["tokens"], z["tokens"])
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    rows = torch.cat([x["tokens"] for x in one])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]      # rows all differ
    counts = torch.bincount(rows.reshape(-1).long(), minlength=512)
    assert counts[0] > counts[100:].float().mean() * 20                  # Zipf: id 0 leads


def test_weights_draw_each_leaf_again_alone(bench):
    root, b = bench
    cell = spec.load_cell("granite-smoke.train", root=root, bench=b)
    ref = spec.reference(cell.config, b)
    w = Weights(ref.layout(cell.config["model"]), 2 ** 40 + 3, "cpu")
    bufs = w.make()
    for path in w.leaves:
        assert torch.equal(w.view(bufs, path), w.initial(path)), path
    tree = w.tree(bufs)
    assert tree["layers"][1]["mlp"]["router"].dtype == torch.float32
    assert tree["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert float(tree["layers"][0]["ln1"].abs().sum()) == 0.0
    again = Weights(ref.layout(cell.config["model"]), 2 ** 40 + 3, "cpu").make()
    assert all(torch.equal(bufs[k], again[k]) for k in bufs)
