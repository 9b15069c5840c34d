"""The port's wavefront module against the JAX package's, on the same numpy
inputs: the recurrence DAG and its diagonals node for node, the LSTM cell,
the sequential interpreter and the stacked static plan within 2e-5 (f32;
the only difference is the order of the sums), the captured sequential LSTM
as a graph of L·T cells that the CPU runtime executes bit for bit like the
eager call, and the same CPF schedule in the simulator."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wavefront as jw
from repro_torch.core import wavefront as tw

TOL = 2e-5
# tests/test_core_wavefront.py::test_stacked_equals_sequential
SHAPES = [(1, 1, 1, 8), (2, 3, 2, 8), (3, 7, 4, 16), (5, 2, 1, 8)]


def _nodes(g):
    return [(n.name, n.kind, n.flops, n.bytes_in, n.bytes_out, n.deps, dict(n.meta))
            for n in g.nodes]


def _stacked(L, H, seed):
    rng = np.random.default_rng(seed)
    p = {"Wx": rng.standard_normal((L, H, 4 * H)) * 0.1,
         "Wh": rng.standard_normal((L, H, 4 * H)) * 0.1,
         "b": rng.standard_normal((L, 4 * H)) * 0.1}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _per_layer(L, D, H, seed):
    """Per-layer params with layer 0 reading D inputs."""
    rng = np.random.default_rng(seed)
    return [{"Wx": (rng.standard_normal((D if l == 0 else H, 4 * H)) * 0.1).astype(np.float32),
             "Wh": (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32),
             "b": (rng.standard_normal(4 * H) * 0.1).astype(np.float32)} for l in range(L)]


def _jax(tree):
    if isinstance(tree, dict):
        return {k: jnp.asarray(v) for k, v in tree.items()}
    return [_jax(t) for t in tree]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("L,T,kw", [(3, 4, {}), (4, 40, {"flops_per_cell": 1e6,
                                                          "bytes_per_cell": 3e3}),
                                    (1, 5, {"kind": "cell"})])
def test_recurrence_graph_and_diagonals_match_reference(L, T, kw):
    g, jg = tw.recurrence_graph(L, T, **kw), jw.recurrence_graph(L, T, **kw)
    assert g.name == jg.name
    assert _nodes(g) == _nodes(jg)
    assert tw.diagonals(L, T) == jw.diagonals(L, T)
    assert tw.cell_name(2, 7) == jw.cell_name(2, 7)


def test_is_wavefront_order_agrees():
    L, T = 3, 5
    g, jg = tw.recurrence_graph(L, T), jw.recurrence_graph(L, T)
    wave = [tw.cell_name(l, t) for d in tw.diagonals(L, T) for l, t in d]
    rng = np.random.default_rng(0)
    for order in (wave, g.topo_order(), list(reversed(wave)), list(rng.permutation(g.names))):
        assert tw.is_wavefront_order(order, g) == jw.is_wavefront_order(order, jg)
    assert tw.is_wavefront_order(wave, g)
    assert not tw.is_wavefront_order(list(reversed(wave)), g)


@pytest.mark.parametrize("B,D,H", [(3, 8, 8), (4, 12, 16)])
def test_lstm_cell_matches_reference(B, D, H):
    rng = np.random.default_rng(B * D)
    p = _per_layer(1, D, H, seed=B)[0]
    x, h, c = (rng.standard_normal((B, n)).astype(np.float32) for n in (D, H, H))
    got = tw.lstm_cell(tw.params_from_jax([p], device="cpu")[0], *map(torch.from_numpy, (x, h, c)))
    want = jw.lstm_cell(_jax(p), jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("L,T,B,H", SHAPES)
def test_stacked_and_sequential_match_reference(L, T, B, H):
    p = _stacked(L, H, seed=L * 100 + T)
    xs = np.random.default_rng(T).standard_normal((T, B, H)).astype(np.float32)
    per_layer = [{k: v[l] for k, v in p.items()} for l in range(L)]
    ref_seq = jw.sequential_lstm(_jax(per_layer), jnp.asarray(xs))
    ref_wav = jw.stacked_wavefront_lstm(_jax(p), jnp.asarray(xs), L)
    seq = tw.sequential_lstm(tw.params_from_jax(per_layer, device="cpu"), torch.from_numpy(xs))
    wav = tw.stacked_wavefront_lstm(tw.params_from_jax(p, device="cpu"), torch.from_numpy(xs), L)
    assert seq.shape == wav.shape == (T, B, H)
    _close(seq, ref_seq)
    _close(wav, ref_wav)
    _close(wav, ref_seq)


def test_sequential_with_input_width_unlike_hidden_matches_reference():
    L, T, B, D, H = 3, 4, 2, 12, 8
    per_layer = _per_layer(L, D, H, seed=11)
    xs = np.random.default_rng(12).standard_normal((T, B, D)).astype(np.float32)
    got = tw.sequential_lstm(tw.params_from_jax(per_layer, device="cpu"), torch.from_numpy(xs))
    _close(got, jw.sequential_lstm(_jax(per_layer), jnp.asarray(xs)))


def test_params_from_jax_keeps_structure_and_values():
    p = _stacked(2, 8, seed=1)
    got = tw.params_from_jax(p, device="cpu")
    assert set(got) == set(p)
    for k in p:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), p[k])
    per = tw.params_from_jax([{k: v[0] for k, v in p.items()}], device="cpu")
    assert np.array_equal(per[0]["Wh"].numpy(), p["Wh"][0])


def test_captured_sequential_lstm_is_a_graph_of_cells_and_runs_like_eager():
    from repro_torch.api import compile as rt_compile
    from repro_torch.core.cost_model import H100
    from repro_torch.runtime import Runtime

    L, T, B, D, H = 3, 4, 2, 12, 8
    per_layer = tw.params_from_jax(_per_layer(L, D, H, seed=4), device="cpu")
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal((T, B, D)).astype(np.float32))
    ref = tw.sequential_lstm(per_layer, xs)
    with Runtime(n_workers=3, device="cpu") as rt:
        exe = rt_compile(tw.sequential_lstm, per_layer, xs, hw=H100, runtime=rt,
                         jit_nodes=True, host_mode="static")
        kinds = [n.kind for n in exe.graph.nodes]
        assert kinds.count("lstm_cell") == L * T
        assert kinds.count("gemm") == 2 * L * T
        # each cell node exports (h, c') and prices 8 ops per gate element
        cell = exe.graph["lstm_cell.5"]
        assert cell.meta["ops"] == ("lstm_cell", "getitem", "getitem")
        assert cell.flops == 8 * B * 4 * H
        assert cell.bytes_out == 2 * B * H * 4
        # the k-th cell is (k // T, k % T): it reads cell k - 1 of its layer
        assert "lstm_cell.4" in cell.deps
        inputs = exe.captured.bind((per_layer, xs))
        assert torch.equal(exe.captured.unflatten(exe.graph.execute(inputs)), ref)
        for mode in ("static", "dynamic"):
            res = exe.execute_host(inputs, n_executors=3, host_mode=mode)
            assert torch.equal(exe.captured.unflatten(res.outputs), ref)
        assert torch.equal(exe(per_layer, xs), ref)


def test_stacked_lstm_has_no_backward_yet():
    """The JAX package differentiates the stacked plan
    (tests/test_core_wavefront.py::test_stacked_jit_and_grad).  Since the
    cell op registered its backward (kernel B4's gradient), the port does
    too (the name is kept from before): every gradient is finite and
    within 2e-5 of ``jax.grad`` of the reference's plan."""
    import jax

    L, T, B, H = 2, 3, 2, 8
    sp = _stacked(L, H, seed=0)
    p = {k: v.requires_grad_(True) for k, v in tw.params_from_jax(sp, device="cpu").items()}
    xs = np.random.default_rng(0).standard_normal((T, B, H)).astype(np.float32)
    loss = (tw.stacked_wavefront_lstm(p, torch.from_numpy(xs), L) ** 2).sum()
    loss.backward()
    want = jax.grad(lambda q: jnp.sum(jw.stacked_wavefront_lstm(q, jnp.asarray(xs), L) ** 2))(
        {k: jnp.asarray(v) for k, v in sp.items()})
    for k in p:
        assert torch.isfinite(p[k].grad).all()
        _close(p[k].grad, want[k])


@pytest.mark.parametrize("L,T", [(4, 12), (4, 40), (3, 7)])
def test_sim_cpf_schedule_matches_reference(L, T):
    from repro import api as j_api
    from repro.core.cost_model import TPUV5E as J_TPUV5E
    from repro_torch.api import compile as rt_compile
    from repro_torch.core.cost_model import TPUV5E
    from repro_torch.runtime import Runtime

    B, H = 16, 128
    kw = {"flops_per_cell": 2 * 2 * B * H * 4 * H, "bytes_per_cell": 3 * B * H * 4}
    jg = jw.recurrence_graph(L, T, **kw)
    jexe = j_api.compile(jg, hw=J_TPUV5E, backend="sim", n_workers=L, reserved_workers=0)
    jexe.profile_with(extra_configs=[(L, 1)])
    g = tw.recurrence_graph(L, T, **kw)
    with Runtime(n_workers=2, device="cpu") as rt:
        exe = rt_compile(g, hw=TPUV5E, backend="sim", n_workers=L, reserved_workers=0,
                         runtime=rt)
        exe.profile_with(extra_configs=[(L, 1)])
        sched, jsched = exe.schedule, jexe.schedule
    assert sched.start_order() == jsched.start_order()
    assert sched.makespan == jsched.makespan
    assert sched.placements == jsched.placements
    assert tw.is_wavefront_order(sched.start_order(), g)
    assert jw.is_wavefront_order(jsched.start_order(), jg)
