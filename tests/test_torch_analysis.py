"""The port's cost walker and roofline against the JAX package's
``repro.analysis`` on the same probes (``tests/test_analysis.py``'s): one
matmul, a matmul repeated in a loop (the reference's scan; ``make_fx``
unrolls the loop, so the walker multiplies nothing), nested loops, a bf16
matmul counted once; the collectives of a traced sharded cell; and
``roofline_report``'s fields given the same numerators and the same
spec."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_cost import ModuleCost as JModuleCost
from repro.analysis.hlo_cost import module_cost as j_module_cost
from repro.analysis.roofline import HardwareSpec as JHardwareSpec
from repro.analysis.roofline import roofline_report as j_roofline_report
from repro_torch.analysis import (H100_SXM, ModuleCost, collective_summary, module_cost,
                                  peak_bytes, roofline_report, trace)
from repro_torch.analysis import fx_cost


def _jcost(fn, *specs):
    return j_module_cost(jax.jit(fn).lower(*specs).compile().as_text())


def test_single_matmul_flops_match_reference():
    M, K, N = 128, 256, 192
    mc = module_cost(trace(lambda x, w: x @ w, torch.randn(M, K), torch.randn(K, N)))
    ref = _jcost(lambda x, w: x @ w, jax.ShapeDtypeStruct((M, K), jnp.float32),
                 jax.ShapeDtypeStruct((K, N), jnp.float32))
    assert mc.flops == 2 * M * K * N
    assert abs(mc.flops - ref.flops) / ref.flops < 0.05
    # operands plus result, in f32
    assert mc.bytes == 4 * (M * K + K * N + M * N)


def test_looped_matmul_counts_every_trip_like_the_reference_scan():
    M, K, N, TRIPS = 64, 128, 128, 12

    def loop(x, w):
        for _ in range(TRIPS):
            x = torch.tanh(x @ w)
        return x.sum()

    def scan(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, None, length=TRIPS)
        return out.sum()

    mc = module_cost(trace(loop, torch.randn(M, K), torch.randn(K, N)))
    ref = _jcost(scan, jax.ShapeDtypeStruct((M, K), jnp.float32),
                 jax.ShapeDtypeStruct((K, N), jnp.float32))
    expect = TRIPS * 2 * M * K * N
    assert expect <= mc.flops <= expect * 1.2
    assert expect <= ref.flops <= expect * 1.2
    assert abs(mc.flops - ref.flops) / ref.flops < 0.05


def test_nested_loops_compound():
    def loops(x):
        for _ in range(7):
            for _ in range(5):
                x = x * 1.0001 + 1.0
        return x.sum()

    def scans(x):
        def outer(c, _):
            def inner(d, _):
                return d * 1.0001 + 1.0, None
            d, _ = jax.lax.scan(inner, c, None, length=5)
            return d, None
        out, _ = jax.lax.scan(outer, x, None, length=7)
        return out.sum()

    mc = module_cost(trace(loops, torch.randn(64)))
    ref = _jcost(scans, jax.ShapeDtypeStruct((64,), jnp.float32))
    assert mc.flops >= 35 * 64 and ref.flops >= 35 * 64
    assert mc.flops == 35 * 2 * 64 + 64          # two ops a trip, and the sum


def test_bf16_matmul_counted_once():
    M = K = N = 256
    mc = module_cost(trace(lambda x, w: x @ w, torch.randn(M, K, dtype=torch.bfloat16),
                           torch.randn(K, N, dtype=torch.bfloat16)))
    ref = _jcost(lambda x, w: x @ w, jax.ShapeDtypeStruct((M, K), jnp.bfloat16),
                 jax.ShapeDtypeStruct((K, N), jnp.bfloat16))
    assert mc.flops == 2 * M * K * N
    assert abs(mc.flops - ref.flops) / ref.flops < 0.05
    assert mc.bytes == 2 * (M * K + K * N + M * N)


def test_kernel_ops_take_their_own_formulas():
    """A B3 call in a trace is counted by the same formula chip_smoke's
    bound uses; its pairs follow the causal mask."""
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn(2, 64, 4, 16)
    k = torch.randn(2, 64, 1, 16)
    mc = module_cost(trace(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, k))
    pairs = fx_cost.flash_pairs(64, 64, True, None)
    assert pairs == 64 * 65 // 2
    flops, nbytes = fx_cost.flash_work(2, 64, 64, 4, 1, 16, 4, pairs)
    assert mc.kernel_calls == {"flash_attention": 1}
    assert mc.flops >= flops and flops == 4.0 * 2 * pairs * 4 * 16
    assert fx_cost.flash_pairs(64, 64, True, 16) == sum(min(i + 1, 16) for i in range(64))


def test_peak_bytes_tracks_liveness():
    x = torch.randn(256, 256)

    def f(x):
        a = x * 2          # live until b is made
        b = a + 1
        return b.sum()

    gm = trace(f, x)
    one = 256 * 256 * 4
    assert peak_bytes(gm) == 3 * one          # the input, a and b together


def test_collectives_found_on_a_traced_sharded_cell():
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell, rank_inputs, rank_program
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"))
    dryrun.init_fake_group(mesh.size)
    try:
        cell = build_cell("gemma-2b", "train_4k", mesh, smoke=True, n_layers=1)
        gm = trace(rank_program(cell, mesh.to_device_mesh("cpu")),
                   *rank_inputs(cell, "cpu", fake=True))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    stats = collective_summary(gm)
    assert stats.total_count > 0 and stats.total_bytes > 0
    assert {"all-gather", "all-reduce"} <= set(stats.per_kind)
    assert "TOTAL" in stats.table()
    mc = module_cost(gm)
    # one layer with remat: its forward twice (the recompute), its backward once
    assert mc.kernel_calls == {"flash_attention_train": 2, "flash_attention_bwd": 1}


@pytest.mark.parametrize("numerators", [
    (2.0e15, 3.0e12, {"all-reduce": (10, 4.0e9), "all-gather": (3, 1.0e9)}, 5.0e10),
    (1.0e9, 8.0e11, {}, 0.0),
    (4.0e12, 1.0e9, {"reduce-scatter": (2, 9.0e11)}, 9.0e10),
])
def test_roofline_report_matches_reference(numerators):
    flops, nbytes, colls, mem = numerators
    jspec = JHardwareSpec(name=H100_SXM.name, peak_flops=H100_SXM.peak_flops,
                          hbm_bw=H100_SXM.hbm_bw, link_bw=H100_SXM.link_bw,
                          hbm_bytes=H100_SXM.hbm_bytes)
    kw = dict(arch="gemma-2b", shape="train_4k", mesh_desc="data=32 x model=8", n_chips=256,
              model_flops_total=3.1e17, bytes_per_device=mem)
    ref = j_roofline_report(hlo_text="", hw=jspec,
                            cost=JModuleCost(flops=flops, bytes=nbytes, collectives=dict(colls)),
                            **kw)
    got = roofline_report(hw=H100_SXM,
                          cost=ModuleCost(flops=flops, bytes=nbytes, collectives=dict(colls)),
                          **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.step_time_bound() == ref.step_time_bound()
    assert got.mfu_bound(H100_SXM) == ref.mfu_bound(jspec)
    assert got.row() == ref.row()
