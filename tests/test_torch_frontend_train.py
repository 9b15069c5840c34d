"""Training of the frontend archs — whisper-medium (an encoder over frame
embeddings, cross-attention in every decoder layer) and llava-next-34b
(image embeddings ahead of the text) — against the JAX package, on the
CPU at smoke size in f32, with the same weights (``params_from_jax``) and
the same numpy batch.

Covers ``forward``'s logits and aux (remat on and off), ``lm_loss`` and
every gradient leaf (the encoder's ``enc_layers`` / ``enc_norm`` and the
decoder's ``xattn`` / ``ln_x`` included) against ``jax.value_and_grad``
of the reference's, llava with and without its image rows, one
``make_train_step`` step (one and two microbatches) against the
reference's, remat's count of B3's training and backward ops, B3's plain
backward at the non-causal cross-attention shapes against ``jax.vjp`` of
``attention_ref``, the loss + gradient graph of ``compile_lm_loss(grad=
True)`` on the CPU runtime (static, dynamic and sequential bit-identical,
equal to eager autograd), the train CLI (llava trains on the text stream;
whisper's first step raises before any update) and the train batches.

Tolerance: 2e-5 in f32 (the two frameworks sum in other orders).  Params
after a step are not compared (AdamW's first step is about ``lr *
sign(g)``; a gradient within rounding of zero may take either sign).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import api as japi
from repro.models import transformer as jt
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
from repro_torch.kernels.flash_attention.ops import _plain_forward
from repro_torch.launch import train as train_cli
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tt
from repro_torch.models.layers import chunked_attention
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import step as tstep
from repro_torch.train.step import (TrainStepConfig, compile_lm_loss, init_train_state,
                                    lm_loss_fn, make_train_step, value_and_grad)

TOL = 2e-5
B, S = 4, 16
# (arch, whether the batch carries the frontend's embeddings): llava also
# trains on a text-only batch, as the reference's forward does
CASES = [("whisper-medium", True), ("llava-next-34b", True), ("llava-next-34b", False)]
IDS = ["whisper", "llava", "llava-text"]


def _setup(arch, seed=0, embeds=True):
    jcfg = j_get_config(arch, smoke=True).reduced(dtype=jnp.float32)
    tcfg = get_config(arch, smoke=True).reduced(dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.key(seed))
    tp = tt.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                        # some ignored positions
    np_batch = {"tokens": toks[:, :S].copy(), "labels": labels}
    if jcfg.frontend == "audio":
        np_batch["frames"] = rng.standard_normal(
            (B, jcfg.encoder_len, jcfg.d_model)).astype(np.float32)
    elif embeds:
        np_batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, np_batch


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def _jax_batch(np_batch):
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


def _by_path(jtree, ttree):
    """(name, port leaf, reference leaf) for every leaf; the reference's
    stacked [L, ...] layer leaves (``layers`` and whisper's
    ``enc_layers``) against the port's per-layer lists."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("layers", "enc_layers"):
            for i in range(np.asarray(leaf).shape[0]):
                t = ttree[keys[0]][i]
                for kk in keys[1:]:
                    t = t[kk]
                out.append((f"{keys[0]}/{i}/{keys[1:]}", t, np.asarray(leaf)[i]))
        else:
            t = ttree
            for kk in keys:
                t = t[kk]
            out.append((str(keys), t, np.asarray(leaf)))
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch,embeds", CASES, ids=IDS)
def test_forward_matches_reference(arch, embeds, remat):
    """Logits over every row (llava's image rows ahead of the text) and
    aux, with remat on and off."""
    jcfg, tcfg, jp, tp, np_batch = _setup(arch, 1, embeds)
    jl, ja = jt.forward(jcfg, jp, _jax_batch(np_batch), remat=remat)
    tl, ta = tt.forward(tcfg, tp, _torch_batch(np_batch), remat=remat)
    n_img = tcfg.n_image_tokens if "image_embeds" in np_batch else 0
    assert tuple(tl.shape) == tuple(jl.shape) == (B, n_img + S, tcfg.padded_vocab)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert ta.item() == float(ja) == 0.0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch,embeds", CASES, ids=IDS)
def test_lm_loss_and_grads_match_reference(arch, embeds, remat):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's ``lm_loss``: whisper's encoder layers, ``enc_norm``
    and every decoder layer's ``xattn`` and ``ln_x`` get their gradient
    through the cross-attention's K / V."""
    jcfg, tcfg, jp, tp, np_batch = _setup(arch, 2, embeds)
    jb = _jax_batch(np_batch)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: japi.lm_loss(jcfg, p, jb, remat=remat), has_aux=True)(jp)
    (tl, tparts), tg = value_and_grad(
        lambda p, b: tapi.lm_loss(tcfg, p, b, remat=remat),
        has_aux=True)(tp, _torch_batch(np_batch))
    np.testing.assert_allclose(tl.item(), float(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tparts["ce"].item(), float(jparts["ce"]), atol=TOL, rtol=TOL)
    assert tparts["aux"].item() == float(jparts["aux"]) == 0.0
    pairs = _by_path(jg, tg)
    assert len(pairs) == len(pytree.tree_leaves(tg))
    names = " ".join(name for name, _, _ in pairs)
    if tcfg.frontend == "audio":
        for leaf in ("enc_layers/", "enc_norm", "'xattn'", "'ln_x'"):
            assert leaf in names, leaf
    for name, got, want in pairs:
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=name)
    if tcfg.frontend == "audio":     # the encoder's gradients are not zero
        assert all(np.abs(g.numpy()).max() > 0
                   for g in pytree.tree_leaves(tg["enc_layers"]) + [tg["enc_norm"]])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,embeds", CASES, ids=IDS)
def test_train_step_matches_reference(arch, embeds, microbatches):
    """One step of the port's ``make_train_step`` and of the reference's
    on the same weights and batch — two microbatches split ``frames`` /
    ``image_embeds`` by rows with the tokens: loss, ce, gradient norm,
    learning rate, clip scale and both moments."""
    jcfg, tcfg, jp, tp, np_batch = _setup(arch, 3, embeds)
    jtc = jstep.TrainStepConfig(microbatches=microbatches, remat=microbatches == 2,
                                warmup_steps=2, total_steps=10)
    jstate = {"params": jp, **jstep.adamw_init(jp, jtc.adamw)}
    jstate, jm = jax.jit(jstep.make_train_step(jcfg, jtc))(jstate, _jax_batch(np_batch))
    state = {"params": tp, **adamw_init(tp)}
    state, tm = make_train_step(tcfg, TrainStepConfig(
        microbatches=microbatches, remat=microbatches == 2, warmup_steps=2,
        total_steps=10))(state, np_batch)
    for k in ("loss", "ce", "grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for tree in ("m", "v"):
        for name, got, want in _by_path(jstate[tree], state[tree]):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                       err_msg=f"{tree} {name}")


class _OpCounts(TorchDispatchMode):
    """Calls of each of this package's custom ops (``repro_torch::*``)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_remat_recomputes_the_decoder_not_the_encoder(arch):
    """B3's training op and its backward a step: whisper's encoder runs
    once (the reference's scan over it has no ``jax.checkpoint``), each
    decoder layer's self- and cross-attention twice with remat; every
    backward once.  llava counts as a dense decoder.  Remat keeps every
    bit of the loss and the gradients."""
    _, tcfg, _, tp, np_batch = _setup(arch, 4)
    batch = _torch_batch(np_batch)
    n_enc, n_dec = tcfg.n_encoder_layers, tcfg.n_layers
    per_layer = 2 if tcfg.cross_attention else 1
    runs = {}
    for remat in (False, True):
        with _OpCounts() as counts:
            runs[remat] = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg, remat=remat))(
                tp, batch))
        fwd = n_enc + (1 + remat) * per_layer * n_dec
        assert counts.n["flash_attention_train"] == fwd
        assert counts.n["flash_attention_bwd"] == n_enc + per_layer * n_dec
        assert counts.n["flash_attention"] == 0
    assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))


def _attention_inputs(Bq, Sq, Skv, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((Bq, Sq, Hq, hd), (Bq, Skv, Hkv, hd), (Bq, Skv, Hkv, hd),
                          (Bq, Sq, Hq, hd))]


# (B, Sq, Skv, Hq, Hkv, hd, chunk, q_chunk): cross-attention's shapes —
# fewer queries than keys, a ragged key count (not a multiple of the
# chunk: the plain version takes the whole length), G = 1 and G = 7, and
# the encoder's Sq = Skv without a mask
CROSS_CASES = [(2, 7, 16, 4, 4, 16, 8, 4), (2, 9, 23, 4, 4, 16, 8, 8),
               (1, 12, 37, 14, 2, 32, 8, 4), (2, 5, 150, 7, 1, 16, 50, 5),
               (2, 16, 16, 4, 4, 16, 8, 8)]


@pytest.mark.parametrize("Bq,Sq,Skv,Hq,Hkv,hd,chunk,q_chunk", CROSS_CASES)
def test_plain_backward_non_causal_matches_attention_ref(Bq, Sq, Skv, Hq, Hkv, hd, chunk,
                                                         q_chunk):
    """B3's plain backward (``flash_attention_bwd_plain``, from the plain
    forward's log-sum-exp) and autograd through the training op, both
    non-causal, against ``jax.vjp`` of ``attention_ref``."""
    arrays = _attention_inputs(Bq, Sq, Skv, Hq, Hkv, hd, seed=Sq * 100 + Skv)
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    jout, vjp = jax.vjp(lambda q, k, v: attention_ref(q, k, v, causal=False), q, k, v)
    want = [np.asarray(x) for x in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    out, lse = _plain_forward(tq, tk, tv, False, None, 0, chunk, q_chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    for got, w in zip(flash_attention_bwd_plain(tdo, tq, tk, tv, out, lse, False, None, 0),
                      want):
        np.testing.assert_allclose(got.numpy(), w, atol=TOL, rtol=TOL)
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = chunked_attention(*ins, causal=False, chunk=chunk, q_chunk=q_chunk)
    for got, w in zip(torch.autograd.grad(o, ins, tdo), want):
        np.testing.assert_allclose(got.numpy(), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_loss_plus_gradient_graph_runs_like_eager(arch):
    """``compile_lm_loss(grad=True)`` captures from ``input_specs``, so its
    graph takes the frontend's embeddings: the encoder's and the
    cross-attention's B3 nodes and their backwards are in it.  The CPU
    runtime's static plan, dynamic scheduler and ``Graph.execute`` give
    eager autograd's loss and gradients bit for bit."""
    from repro_torch.runtime import Runtime

    _, tcfg, _, _, _ = _setup(arch)
    tp = tt.init_params(tcfg, 5, device="cpu")      # the structure the specs have
    seq = S + (tcfg.n_image_tokens if tcfg.frontend == "vision" else 0)
    shape = ShapeSpec("t", seq, B, "train")
    batch = tapi.make_batch(tcfg, shape, torch.Generator().manual_seed(5))
    n_attn = tcfg.n_encoder_layers + tcfg.n_layers * (2 if tcfg.cross_attention else 1)
    with Runtime(2, device="cpu") as rt:
        exe = compile_lm_loss(tcfg, shape, backend="host", grad=True, runtime=rt, device="cpu")
        assert [n.kind for n in exe.graph.nodes].count("attention") == 2 * n_attn
        want = pytree.tree_leaves(value_and_grad(lm_loss_fn(tcfg))(tp, batch))
        inputs = exe.captured.bind((tp, batch))
        runs = [exe.captured.unflatten(exe.execute_host(inputs, host_mode=m).outputs)
                for m in ("static", "dynamic")]
        runs.append(exe.captured.unflatten(exe.graph.execute(inputs)))
    for run in runs:
        got = pytree.tree_leaves(run)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_cli_trains_llava_on_the_text_stream(capsys):
    """As the reference's CLI: the loss graph is captured with the image
    rows (``input_specs``), the synthetic stream's batches carry tokens
    only, and the model trains on them as text."""
    assert train_cli.main(["--arch", "llava-next-34b", "--smoke", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "16",
                           "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "graphi: loss graph" in out
    assert "done: 3 steps, 0 restarts" in out


def test_train_cli_whisper_fails_at_its_first_step_before_any_update(monkeypatch):
    """The synthetic stream has no ``frames``: whisper's first step raises
    (the reference's ``KeyError``; here a ``ValueError`` that names
    them), after the loss graph was captured and before any update."""
    def no_update(*a, **k):
        raise AssertionError("an AdamW update ran")

    monkeypatch.setattr(tstep, "adamw_update", no_update)
    with pytest.raises(ValueError, match=r"batch\['frames'\]"):
        train_cli.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "8"])


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_train_batches_carry_the_embeddings_and_train(arch):
    """``make_batch(kind="train")`` and ``input_specs(kind="train")``: the
    text's tokens and labels beside the frontend's embeddings (llava's
    image rows take ``min(n_image_tokens, seq // 2)`` of the sequence),
    and such a batch trains: a train state builds, and a step on it has a
    finite loss scored over the text alone."""
    cfg = get_config(arch, smoke=True)
    seq = 24
    shape = ShapeSpec("t", seq, 2, "train")
    batch = tapi.make_batch(cfg, shape, torch.Generator().manual_seed(6), kind="train")
    specs = tapi.input_specs(cfg, shape, kind="train", device="cpu")
    n_img = min(cfg.n_image_tokens, seq // 2) if cfg.frontend == "vision" else 0
    want = {"tokens": (2, seq - n_img), "labels": (2, seq - n_img)}
    want.update({"frames": (2, cfg.encoder_len, cfg.d_model)} if cfg.frontend == "audio"
                else {"image_embeds": (2, n_img, cfg.d_model)})
    assert {k: tuple(v.shape) for k, v in batch.items()} == want
    assert {k: tuple(v.shape) for k, v in specs.items()} == want
    assert all(batch[k].dtype == specs[k].dtype for k in want)
    state = init_train_state(cfg, 0, AdamWConfig(lr=1e-3), device="cpu")
    assert len(state["params"]["layers"]) == cfg.n_layers
    state, metrics = make_train_step(cfg, TrainStepConfig(remat=True, warmup_steps=1,
                                                          total_steps=4))(state, batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    logits, _ = tt.forward(cfg, state["params"], batch)
    assert logits.shape[1] == seq
