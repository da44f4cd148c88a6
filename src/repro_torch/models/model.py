"""Model-level entry points: embed, head, forward, prefill, decode, generate.

Ports ``repro/models/model.py`` for decoder-only models, with tied or
untied heads.  These are the single-program reference paths; the serving
engine composes the same blocks per stage.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import BlockCtx, apply_block


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 pos0=0) -> torch.Tensor:
    if cfg.rope_theta == 0:
        raise NotImplementedError("learned position embeddings are not "
                                  "ported to repro_torch yet; see ROADMAP.md")
    return params["embed"][tokens]


def lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the output projection: the tied embedding, or
    ``lm_head (d, V)``."""
    h = L.rms_norm(params["final_norm"], x, cfg.rms_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            cache: Optional[list] = None, pos0=0):
    """Run all decoder blocks.  Returns (logits, cache, aux); ``cache`` is
    updated in place."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens, pos0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(params["blocks"]):
        ctx = BlockCtx(pos0=pos0, cache=cache[i] if cache is not None else None,
                       is_global=cfg.is_global_layer(i), causal=True)
        x, _, a = apply_block(cfg, cfg.layer_kind(i), bp, x, ctx)
        aux = aux + a
    return lm_head(cfg, params, x), cache, aux


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Process the prompt, build the cache.  Returns (last_logits, cache)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                       device=tokens.device)
    logits, cache, _ = forward(cfg, params, batch, cache=cache, pos0=0)
    return logits[:, -1, :], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: list, pos):
    """One decode step.  token: (B, 1); pos: cache length (int, or (B,)).
    Returns (logits (B, vocab), cache)."""
    logits, cache, _ = forward(cfg, params, {"tokens": token}, cache=cache,
                               pos0=pos)
    return logits[:, -1, :], cache


def greedy_generate(cfg: ModelConfig, params: dict, batch: dict, steps: int,
                    max_seq: int):
    """Reference autoregressive loop.  Returns (tokens (B, steps), cache)."""
    last, cache = prefill(cfg, params, batch, max_seq)
    pos = batch["tokens"].shape[1]
    toks = []
    tok = torch.argmax(last, dim=-1)[:, None]
    for _ in range(steps):
        toks.append(tok)
        logits, cache = decode_step(cfg, params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)[:, None]
        pos += 1
    return torch.cat(toks, dim=1), cache
