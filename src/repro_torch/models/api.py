"""Model API: the LM loss, batch construction (real tensors from a
``torch.Generator``, and fake-tensor specs for capture) and analytic FLOPs
accounting (MODEL_FLOPS = 6·N·D) — the JAX package's ``models/api.py``.

The port trains every arch it serves through its training forward
(:func:`repro_torch.models.transformer.forward`): dense and MoE decoders,
Mamba and Griffin (RG-LRU + local attention), and the frontend archs
(the reference's vision and audio stubs); a MoE arch's loss adds
``aux_weight`` times its load-balancing loss, and its FLOPs count the
active (top-k) experts.  :func:`make_batch` and :func:`input_specs` give
a non-decode batch (train or prefill) the frontend's ``image_embeds``
``[B, min(n_image_tokens, seq_len // 2), d_model]``, ahead of ``seq_len
- n_img`` text tokens, or ``frames`` ``[B, encoder_len, d_model]``, as
the reference's do; :func:`lm_loss` scores the text's positions only.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec

from . import transformer

__all__ = [
    "IGNORE",
    "lm_loss",
    "make_batch",
    "input_specs",
    "model_train_flops",
    "model_decode_flops",
    "model_prefill_flops",
    "model_flops",
    "token_counts",
]

IGNORE = -1  # label id excluded from the loss (e.g. image positions)


def _vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor with its vocabulary split over the
    mesh (the sharded path's column-parallel unembedding)."""
    from repro_torch.dist.sharding import is_dtensor

    if not is_dtensor(logits):
        return False
    from torch.distributed.tensor import Shard

    mesh = logits.device_mesh
    return any(p in (Shard(-1), Shard(logits.dim() - 1)) and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def lm_loss(cfg: ModelConfig, params, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy (+ MoE aux).  Labels = tokens shifted
    inside ``make_batch``; positions with label == IGNORE are masked.
    Logits whose vocabulary is sharded over a mesh take the vocab-parallel
    cross-entropy (``dist.kernel_rules.vocab_parallel_nll``)."""
    logits, aux = transformer.forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    # frontends prepend non-text positions: align logits tail to labels
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    mask = (labels != IGNORE) & (labels < cfg.vocab_size)
    safe = torch.where(mask, labels, 0).long()
    if _vocab_sharded(logits):
        from repro_torch.dist import kernel_rules

        nll = kernel_rules.vocab_parallel_nll(logits, safe)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def token_counts(cfg: ModelConfig, shape: ShapeSpec) -> tuple[int, int, int]:
    """(batch, text_len, total_seq) honoring frontend stubs: vlm reserves
    n_image_tokens of the sequence budget for patch embeddings."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision" and shape.kind != "decode":
        n_img = min(cfg.n_image_tokens, S // 2)
        return B, S - n_img, S
    return B, S, S


def _frontend_shapes(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, tuple[int, ...]]:
    """The frontend stub's inputs of a non-decode batch: precomputed patch
    embeddings (vision, ahead of the text) or frame embeddings (audio, the
    encoder's input)."""
    B = shape.global_batch
    if cfg.frontend == "vision":
        return {"image_embeds": (B, min(cfg.n_image_tokens, shape.seq_len // 2), cfg.d_model)}
    if cfg.frontend == "audio":
        return {"frames": (B, cfg.encoder_len, cfg.d_model)}
    return {}


def make_batch(cfg: ModelConfig, shape: ShapeSpec, generator: torch.Generator, *,
               kind: str | None = None) -> dict:
    """Concrete random batch (smoke tests / examples), drawn from
    ``generator`` on its device.  The numbers differ from the JAX
    package's for the same seed; parity tests build batches with numpy."""
    kind = kind or shape.kind
    B, S_text, _ = token_counts(cfg, shape)
    dev = generator.device
    if kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, 1), generator=generator,
                                        device=dev, dtype=torch.int32)}
    tokens = torch.randint(0, cfg.vocab_size, (B, S_text), generator=generator, device=dev,
                           dtype=torch.int32)
    batch: dict[str, Any] = {"tokens": tokens}
    if kind == "train":
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = IGNORE
        batch["labels"] = labels
    for name, dims in _frontend_shapes(cfg, shape).items():
        batch[name] = torch.randn(dims, generator=generator, device=dev,
                                  dtype=torch.float32).to(cfg.dtype)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, kind: str | None = None,
                device: str | torch.device = "cuda", fake_mode=None) -> dict:
    """Fake-tensor stand-ins for every model input on ``device`` (shapes,
    dtypes and the device only: nothing is allocated), the specs the
    port's capture takes.  Capture needs every fake input from one
    ``FakeTensorMode``: pass the one the other specs came from (a new one
    otherwise)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.device import resolve_device

    kind = kind or shape.kind
    B, S_text, _ = token_counts(cfg, shape)
    dev = resolve_device(device)
    with fake_mode or FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "decode":
            return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=dev)}
        specs: dict[str, Any] = {"tokens": torch.empty((B, S_text), dtype=torch.int32,
                                                       device=dev)}
        if kind == "train":
            specs["labels"] = torch.empty((B, S_text), dtype=torch.int32, device=dev)
        for name, dims in _frontend_shapes(cfg, shape).items():
            specs[name] = torch.empty(dims, dtype=cfg.dtype, device=dev)
    return specs


def model_train_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for a train step: 6·N·D (N = active params, D = tokens).

    The standard accounting (Kaplan): 2ND forward + 4ND backward, attention
    excluded (reported separately in the roofline table's notes).
    """
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * cfg.active_params() * tokens


def model_decode_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for one decode step: 2·N_active·B (one token per seq)."""
    return 2.0 * cfg.active_params() * shape.global_batch


def model_prefill_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for a prefill (forward only): 2·N_active·tokens."""
    tokens = shape.global_batch * shape.seq_len
    return 2.0 * cfg.active_params() * tokens


def model_flops(cfg: ModelConfig, shape: ShapeSpec, kind: str | None = None) -> float:
    kind = kind or shape.kind
    if kind == "train":
        return model_train_flops(cfg, shape)
    if kind == "prefill":
        return model_prefill_flops(cfg, shape)
    return model_decode_flops(cfg, shape)
