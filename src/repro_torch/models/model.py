"""Model-level entry points: embed, head, encoder, forward, prefill, decode,
generate.

Ports ``repro/models/model.py``: decoder-only models
with tied or untied heads, learned positions (``pos_embed``, where
``rope_theta == 0``), cross-attention memory, and whisper's encoder.  These
are the single-program reference paths; the serving engine composes the
same blocks per stage, and ``loss_fn`` is the reference the one-rank
train step (``parallel/pipeline.py``) is held to.

Batch dict convention, as the reference's:
  tokens:  (B, S) int         decoder tokens
  frames:  (B, S_enc, d)      encoder input (whisper's conv frontend stub)
  memory:  (B, M, d)          image tokens (the vision frontend stub)
  labels:  (B, S) int         training targets
  mask:    (B, S) float       optional weights of the targets
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MIXER_ATTN, LayerKind, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import BlockCtx, apply_block
from repro_torch.parallel import comm


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 pos0=0) -> torch.Tensor:
    """Token embeddings, plus learned positions from ``pos0`` where the
    model has them."""
    x = params["embed"][tokens]
    if cfg.rope_theta == 0 and "pos_embed" in params:
        pe = params["pos_embed"][L.positions(pos0, tokens.shape[1],
                                             x.device)]
        x = x + (pe[None] if pe.ndim == 2 else pe)
    return x


def lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the output projection: the tied embedding, or
    ``lm_head (d, V)``."""
    h = L.rms_norm(params["final_norm"], x, cfg.rms_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w)


def run_encoder(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                tp_axis=None) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, S_enc, d):
    learned positions, non-causal attention blocks with no cache, then the
    encoder's final norm.  Returns the decoder's memory (B, S_enc, d)."""
    x = frames
    if cfg.rope_theta == 0 and "pos_embed" in params:
        x = x + params["pos_embed"][:x.shape[1]][None]
    ctx = BlockCtx(causal=False, tp_axis=tp_axis)
    kind = LayerKind(mixer=MIXER_ATTN)
    for bp in params["encoder"]["blocks"]:
        x, _, _ = apply_block(cfg, kind, bp, x, ctx)
    return L.rms_norm(params["encoder"]["final_norm"], x, cfg.rms_eps)


def _decoder_memory(cfg: ModelConfig, params: dict, batch: dict, tp_axis):
    if cfg.encoder_layers and "frames" in batch:
        return run_encoder(cfg, params, batch["frames"], tp_axis)
    return batch.get("memory")


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            cache: Optional[list] = None, pos0=0, tp_axis=None):
    """Run all decoder blocks.  Returns (logits, cache, aux); ``cache`` is
    updated in place.  ``tp_axis``: the blocks' params are a rank's
    tensor-parallel shards along that mesh axis."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens, pos0)
    memory = _decoder_memory(cfg, params, batch, tp_axis)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(params["blocks"]):
        ctx = BlockCtx(pos0=pos0, cache=cache[i] if cache is not None else None,
                       memory=memory, is_global=cfg.is_global_layer(i),
                       causal=True, tp_axis=tp_axis)
        x, _, a = apply_block(cfg, cfg.layer_kind(i), bp, x, ctx)
        aux = aux + a
    return lm_head(cfg, params, x), cache, aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01, tp_axis=None):
    """Next-token cross entropy (f32 log-softmax NLL, weighted by
    ``mask``) plus ``aux_weight`` times the MoE aux loss.  Returns (total,
    {"nll", "aux"})."""
    logits, _, aux = forward(cfg, params, batch, tp_axis=tp_axis)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + aux_weight * aux
    return total, {"nll": loss, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int,
            cache_dtype=torch.bfloat16, tp_axis=None):
    """Process the prompt, build the cache.  Returns (last_logits, cache).
    Under ``tp_axis`` the cache takes the rank's local shapes (its share of
    the kv heads or channels), where the reference allocates whole caches
    and writes its local heads into the first of them."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                       device=tokens.device,
                       tensor_shards=comm.axis_size(tp_axis)
                       if tp_axis else 1)
    logits, cache, _ = forward(cfg, params, batch, cache=cache, pos0=0,
                               tp_axis=tp_axis)
    return logits[:, -1, :], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: list, pos, memory=None, tp_axis=None):
    """One decode step.  token: (B, 1); pos: cache length (int, or (B,));
    ``memory``, where given, is projected again by every cross layer
    instead of reading its cache.  Returns (logits (B, vocab), cache)."""
    batch = {"tokens": token}
    if memory is not None:
        batch["memory"] = memory
    logits, cache, _ = forward(cfg, params, batch, cache=cache, pos0=pos,
                               tp_axis=tp_axis)
    return logits[:, -1, :], cache


def greedy_generate(cfg: ModelConfig, params: dict, batch: dict, steps: int,
                    max_seq: int, tp_axis=None):
    """Reference autoregressive loop.  Returns (tokens (B, steps), cache)."""
    last, cache = prefill(cfg, params, batch, max_seq, tp_axis=tp_axis)
    pos = batch["tokens"].shape[1]
    memory = batch.get("memory")
    toks = []
    tok = torch.argmax(last, dim=-1)[:, None]
    for _ in range(steps):
        toks.append(tok)
        logits, cache = decode_step(cfg, params, tok, cache, pos, memory,
                                    tp_axis)
        tok = torch.argmax(logits, dim=-1)[:, None]
        pos += 1
    return torch.cat(toks, dim=1), cache
