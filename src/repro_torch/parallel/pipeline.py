"""GPipe pipeline training, at one rank.

Ports the train step of ``repro/parallel/pipeline.py``: the stacked param
layout (``stack_params``, ``unstack_params``), the vocab-parallel embedding,
head and seq-chunked cross entropy at one vocab shard (``vp_embed``,
``vp_logits``, ``vp_cross_entropy``), stage execution (``run_stage``,
``run_encoder_stacked``), the microbatch tick loop (``pipeline_seq_pass``)
and ``build_train_step``, which differentiates the loss, clips and applies
AdamW.

Differences in idiom: params are dicts of tensors; ``jax.checkpoint``
becomes ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``;
the donated params and optimizer moments are updated in place.

One rank only (plan S = T = R = 1): the stage rotation, the vocab shards'
psums and the gradient all-reduce are identities there, and the tick loop
keeps its M + S - 1 ticks and its microbatch emission.  Several stages,
tensor parallelism, replicas, FSDP, compressed cross-pod reduction and
sequence-parallel KV need collectives and raise ``NotImplementedError``
(ROADMAP.md, section 1, the multi-rank item), as do the prefill and decode
steps built on the same layout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (LayerKind, ModelConfig, PipelinePlan,
                                      ShapeConfig)
from repro_torch.models import layers as L
from repro_torch.models.transformer import BlockCtx, apply_block, model_spec
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

f32 = torch.float32


def _multi_rank(what: str):
    return NotImplementedError(
        f"{what} needs collectives across ranks and is not ported to "
        "repro_torch yet; see ROADMAP.md, section 1 (multi-rank execution "
        "with torch.distributed)")


def _one_rank(plan: PipelinePlan) -> None:
    if plan.model_axis > 1:
        raise _multi_rank(f"a plan with S*T*R = {plan.model_axis} "
                          f"(S={plan.stages}, T={plan.tensor}, "
                          f"R={plan.replica})")
    if plan.fsdp:
        raise _multi_rank("FSDP")
    if plan.seq_parallel_kv:
        raise _multi_rank("sequence-parallel KV")


# ---------------------------------------------------------------------------
# Param stacking
# ---------------------------------------------------------------------------

def _tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def stack_params(cfg: ModelConfig, plan: PipelinePlan, params: dict) -> dict:
    """Unstacked model params -> stage-stacked tree.

    Layer i = (s*pps + p)*ps + j lives at stages[str(j)][s, p]."""
    S = plan.stages
    ps = cfg.pattern_size
    pps = cfg.n_patterns // S
    blocks = params["blocks"]
    stages = {}
    for j in range(ps):
        per_stage = [
            _tree_stack([blocks[(s * pps + p) * ps + j] for p in range(pps)])
            for s in range(S)]
        stages[str(j)] = _tree_stack(per_stage)
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "stages": stages}
    for k in ("lm_head", "pos_embed"):
        if k in params:
            out[k] = params[k]
    if "encoder" in params:
        if plan.stages != 1:
            raise ValueError("encoder-decoder supports S=1 only "
                             "(DESIGN.md §5)")
        out["encoder"] = {
            "blocks": _tree_stack(params["encoder"]["blocks"]),
            "final_norm": params["encoder"]["final_norm"]}
    return out


def unstack_params(cfg: ModelConfig, plan: PipelinePlan,
                   stacked: dict) -> dict:
    """The inverse of ``stack_params``; block leaves are views into the
    stacked ones."""
    S, ps = plan.stages, cfg.pattern_size
    pps = cfg.n_patterns // S
    blocks = [None] * cfg.n_layers
    for j in range(ps):
        tree = stacked["stages"][str(j)]
        for s in range(S):
            for p in range(pps):
                blocks[(s * pps + p) * ps + j] = tree_map(
                    lambda leaf: leaf[s, p], tree)
    out = {"embed": stacked["embed"], "final_norm": stacked["final_norm"],
           "blocks": blocks}
    for k in ("lm_head", "pos_embed"):
        if k in stacked:
            out[k] = stacked[k]
    if "encoder" in stacked:
        out["encoder"] = {
            "blocks": [tree_map(lambda leaf: leaf[i],
                                stacked["encoder"]["blocks"])
                       for i in range(cfg.encoder_layers)],
            "final_norm": stacked["encoder"]["final_norm"]}
    return out


def _spec_struct(spec, dtype):
    if isinstance(spec, dict):
        return {k: _spec_struct(v, dtype) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_struct(v, dtype) for v in spec]
    return torch.empty(spec[0], dtype=dtype, device="meta")


def stacked_param_struct(cfg: ModelConfig, plan: PipelinePlan,
                         dtype=torch.bfloat16):
    """The stacked params' shapes and dtypes as meta tensors (nothing
    allocated), the counterpart of the reference's ShapeDtypeStruct tree."""
    return stack_params(cfg, plan, _spec_struct(model_spec(cfg), dtype))


# ---------------------------------------------------------------------------
# Vocab-parallel embed / head / cross-entropy, at one vocab shard
# ---------------------------------------------------------------------------

# this rank's index over the (stage, tensor) vocab shards: one shard
_VP_RANK = 0


def vp_embed(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
             tokens: torch.Tensor, pos0=0) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d); the embed table is this rank's vocab
    shard (all of it at one rank, where the shards' psum is the identity)."""
    emb = stacked["embed"]
    Vloc = emb.shape[0]
    lid = tokens.long() - _VP_RANK * Vloc
    valid = (lid >= 0) & (lid < Vloc)
    x = emb[torch.clamp(lid, 0, Vloc - 1)] * valid[..., None].to(emb.dtype)
    if cfg.rope_theta == 0 and "pos_embed" in stacked:
        S = tokens.shape[1]
        pos = pos0 + torch.arange(S, device=tokens.device)
        x = x + stacked["pos_embed"][pos][None].to(x.dtype)
    return x


def _vp_head_w(cfg: ModelConfig, stacked: dict):
    return stacked["embed"].t() if cfg.tie_embeddings else stacked["lm_head"]


def vp_logits(cfg: ModelConfig, stacked: dict,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm and head on the local vocab slice.  x (B, S, d) -> (B, S,
    Vloc)."""
    h = L.rms_norm(stacked["final_norm"], x, cfg.rms_eps)
    return torch.matmul(h, _vp_head_w(cfg, stacked))


def vp_cross_entropy(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                     x: torch.Tensor, labels: torch.Tensor,
                     chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Vocab-parallel cross entropy, seq-chunked (the head's logits are
    made one chunk of ``chunk`` positions at a time).  Returns (sum_nll,
    token_count); token_count counts the positions the chunks cover, as
    the reference's does."""
    B, S, d = x.shape
    Vloc = stacked["embed"].shape[0]
    w = _vp_head_w(cfg, stacked)
    h = L.rms_norm(stacked["final_norm"], x, cfg.rms_eps)

    nchunk = max(S // max(min(chunk, S), 1), 1)
    csz = S // nchunk
    total = torch.zeros((), dtype=f32, device=x.device)
    for c in range(nchunk):
        hx = h[:, c * csz:(c + 1) * csz]
        lb = labels[:, c * csz:(c + 1) * csz].long()
        logits = torch.matmul(hx, w).float()
        # the max is a shift for stability: no gradient flows through it
        m = logits.max(dim=-1).values.detach()
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = m + torch.log(se)
        lid = lb - _VP_RANK * Vloc
        valid = (lid >= 0) & (lid < Vloc)
        ll = torch.gather(logits, -1,
                          torch.clamp(lid, 0, Vloc - 1)[..., None])[..., 0]
        ll = torch.where(valid, ll, torch.zeros_like(ll))
        total = total + (lse - ll).sum()
    # a fill on the device, not a host-to-device copy
    return total, torch.full((), float(B * nchunk * csz), dtype=f32,
                             device=x.device)


# ---------------------------------------------------------------------------
# Stage execution
# ---------------------------------------------------------------------------

def _stage_kinds(cfg: ModelConfig):
    return [cfg.layer_kind(j) for j in range(cfg.pattern_size)]


def run_stage(cfg: ModelConfig, plan: PipelinePlan, stage_params: dict,
              x: torch.Tensor, cache: Optional[dict], *, pos0, memory=None,
              causal=True, sp_axis=None, kv_block=1024, remat=False,
              fsdp_dims=None):
    """Apply one stage (pps repeating patterns).  ``stage_params`` leaves
    have a leading (pps,) dim.  Returns (x, caches, aux_sum); with
    ``remat`` each pattern is recomputed in the backward pass."""
    if plan.tensor > 1 or sp_axis is not None:
        raise _multi_rank("tensor- or sequence-parallel stages")
    if fsdp_dims is not None:
        raise _multi_rank("FSDP")
    if cache is not None:
        raise _multi_rank("prefill and decode through the stacked layout "
                          "(build_prefill_step, build_decode_step)")
    kinds = _stage_kinds(cfg)

    def pattern_body(x, params_p):
        aux = torch.zeros((), dtype=f32, device=x.device)
        for j, kind in enumerate(kinds):
            ctx = BlockCtx(pos0=pos0, memory=memory,
                           is_global=cfg.is_global_layer(j), causal=causal)
            x, _, a = apply_block(cfg, kind, params_p[str(j)], x, ctx)
            aux = aux + a
        return x, aux

    # one unbind per leaf: its backward stacks the pps slices' gradients
    # once, where indexing each slice would give each one a full-size zero
    # gradient to add (pps^2 leaf sizes of writes)
    leaves, treedef = tree_flatten(stage_params)
    slices = [leaf.unbind(0) for leaf in leaves]
    auxs = []
    for p in range(len(slices[0])):
        params_p = tree_unflatten(treedef, [sl[p] for sl in slices])
        if remat:
            x, a = checkpoint(pattern_body, x, params_p, use_reentrant=False)
        else:
            x, a = pattern_body(x, params_p)
        auxs.append(a)
    return x, None, torch.stack(auxs).sum()


def run_encoder_stacked(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                        frames: torch.Tensor, kv_block=1024) -> torch.Tensor:
    """Whisper's encoder (S=1) over the stacked encoder blocks."""
    if plan.tensor > 1:
        raise _multi_rank("a tensor-parallel encoder")
    x = frames
    if cfg.rope_theta == 0 and "pos_embed" in stacked:
        x = x + stacked["pos_embed"][:x.shape[1]][None].to(x.dtype)
    kind = LayerKind()                 # the default attention / dense kind
    blocks = stacked["encoder"]["blocks"]
    for i in range(cfg.encoder_layers):
        bp = tree_map(lambda leaf: leaf[i], blocks)
        x, _, _ = apply_block(cfg, kind, bp, x, BlockCtx(causal=False))
    return L.rms_norm(stacked["encoder"]["final_norm"], x, cfg.rms_eps)


# ---------------------------------------------------------------------------
# Pipelined sequence pass (train forward)
# ---------------------------------------------------------------------------

def pipeline_seq_pass(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                      tokens: torch.Tensor, *, labels=None, caches=None,
                      memory_all=None, frames_all=None, kv_block=1024,
                      remat=False, fsdp_ctx=None):
    """Pipelined pass over full sequences (the train forward).

    tokens (Bl, S) local batch; M = plan.microbatches must divide Bl.  The
    loop runs M + S - 1 ticks; at tick t stage 0 takes microbatch t and the
    last stage emits microbatch t - (S - 1), whose loss it adds.  With
    ``remat`` each tick is recomputed in the backward pass from its
    (small) carried state.  Returns a dict with loss_sum, token_count (if
    labels), aux, caches and last_logits (None: prefill through this layout
    is not ported)."""
    _one_rank(plan)
    if fsdp_ctx is not None:
        raise _multi_rank("FSDP")
    if caches is not None:
        raise _multi_rank("prefill through the stacked layout "
                          "(build_prefill_step)")
    Bl, Sq = tokens.shape
    M = plan.microbatches
    if Bl % M:
        raise ValueError(f"batch {Bl} not divisible by M={M} microbatches")
    Bm = Bl // M
    S_st = plan.stages
    stage_idx = 0                      # this rank's stage
    d = cfg.d_model
    dt = stacked["embed"].dtype
    dev = tokens.device
    stage_params = tree_map(lambda leaf: leaf[0], stacked["stages"])

    toks = tokens.reshape(M, Bm, Sq)
    labs = labels.reshape(M, Bm, Sq) if labels is not None else None
    n_ticks = M + S_st - 1

    def tick(t, state, loss_sum, tok_count, aux_sum):
        mb_in = min(max(t, 0), M - 1)
        x_in = vp_embed(cfg, plan, stacked, toks[mb_in])
        # this rank's CURRENT microbatch (for the memory)
        mb_cur = min(max(t - stage_idx, 0), M - 1)
        valid_cur = 0 <= t - stage_idx < M
        if stage_idx == 0:
            state = x_in.to(dt)

        memory = None
        if memory_all is not None:
            memory = memory_all[mb_cur]
        if frames_all is not None:
            memory = run_encoder_stacked(cfg, plan, stacked,
                                         frames_all[mb_cur], kv_block)

        out, _, aux = run_stage(cfg, plan, stage_params, state, None,
                                pos0=0, memory=memory, causal=True,
                                kv_block=kv_block, remat=False)
        if valid_cur:
            aux_sum = aux_sum + aux

        # emission from the last stage
        mb_out = min(max(t - (S_st - 1), 0), M - 1)
        emit = t >= S_st - 1 and t - (S_st - 1) < M
        if labs is not None and emit:
            nll, cnt = vp_cross_entropy(cfg, plan, stacked, out, labs[mb_out])
            loss_sum = loss_sum + nll
            tok_count = tok_count + cnt
        return out, loss_sum, tok_count, aux_sum   # rotation: the identity

    zero = torch.zeros((), dtype=f32, device=dev)
    state = torch.zeros((Bm, Sq, d), dtype=dt, device=dev)
    loss_sum, tok_count, aux_sum = zero, zero.clone(), zero.clone()
    for t in range(n_ticks):
        # remat at TICK granularity: the backward recomputes the whole tick
        # from its carried state instead of keeping every layer's residuals
        if remat:
            state, loss_sum, tok_count, aux_sum = checkpoint(
                tick, t, state, loss_sum, tok_count, aux_sum,
                use_reentrant=False)
        else:
            state, loss_sum, tok_count, aux_sum = tick(
                t, state, loss_sum, tok_count, aux_sum)
    return {"loss_sum": loss_sum, "token_count": tok_count, "aux": aux_sum,
            "caches": None, "last_logits": None}


# ---------------------------------------------------------------------------
# Step builder
# ---------------------------------------------------------------------------

def batch_struct(cfg: ModelConfig, shape: ShapeConfig, plan: PipelinePlan,
                 dtype=torch.bfloat16) -> dict:
    """The step's global inputs as meta tensors."""
    B = shape.global_batch
    Sq = 1 if shape.is_decode else shape.seq_len
    out = {"tokens": torch.empty((B, Sq), dtype=torch.int32, device="meta")}
    if shape.kind == "train":
        out["labels"] = torch.empty((B, Sq), dtype=torch.int32,
                                    device="meta")
    if cfg.encoder_layers and shape.kind != "decode":
        out["frames"] = torch.empty((B, shape.seq_len, cfg.d_model),
                                    dtype=dtype, device="meta")
    if cfg.n_memory_tokens and not cfg.encoder_layers \
            and shape.kind != "decode":
        out["memory"] = torch.empty((B, cfg.n_memory_tokens, cfg.d_model),
                                    dtype=dtype, device="meta")
    return out


def build_train_step(cfg: ModelConfig, plan: PipelinePlan, base_mesh,
                     shape: ShapeConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                     param_dtype=torch.bfloat16, compress_pod: bool = False,
                     aux_weight: float = 0.01):
    """Returns (step, structs): ``step(params, opt, batch)`` gives (params,
    opt, {"loss", "aux", "grad_norm", "lr"}), the stacked params and the
    moments updated in place.  ``base_mesh`` must be None (one rank; the
    reference takes its device mesh here)."""
    _one_rank(plan)
    if base_mesh is not None:
        raise _multi_rank("a device mesh")
    if compress_pod:
        raise _multi_rank("compressed cross-pod gradient reduction")
    pstruct = stacked_param_struct(cfg, plan, param_dtype)
    ostruct = OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(lambda s: torch.empty(s.shape, dtype=f32, device="meta"),
                   pstruct),
        v=tree_map(lambda s: torch.empty(s.shape, dtype=f32, device="meta"),
                   pstruct))
    bstruct = batch_struct(cfg, shape, plan, param_dtype)
    M = plan.microbatches

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        diff = [leaf.detach().requires_grad_(True) for leaf in leaves]
        p = tree_unflatten(treedef, diff)
        tokens = batch["tokens"]
        Bl = tokens.shape[0]
        Bm = Bl // M
        frames_all = memory_all = None
        if "frames" in batch:
            f = batch["frames"]
            frames_all = f.reshape(M, Bm, *f.shape[1:])
        if "memory" in batch:
            m = batch["memory"]
            memory_all = m.reshape(M, Bm, *m.shape[1:])
        with torch.enable_grad():
            res = pipeline_seq_pass(
                cfg, plan, p, tokens, labels=batch["labels"],
                frames_all=frames_all, memory_all=memory_all,
                remat=plan.remat)
            loss = res["loss_sum"] / torch.clamp(res["token_count"], min=1.0)
            aux = res["aux"] / max(M * cfg.n_layers, 1)
            total = loss + aux_weight * aux
            grads = torch.autograd.grad(total, diff, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        # the exact global ||g||^2 (one rank: every leaf is whole)
        nsq = torch.zeros((), dtype=f32, device=tokens.device)
        for g in grads:
            nsq = nsq + torch.sum(torch.square(g.float()))
        new_p, new_o, om = adamw_update(opt_cfg, params,
                                        tree_unflatten(treedef, grads),
                                        opt_state, extra_norm_sq=nsq)
        metrics = {"loss": loss.detach(), "aux": aux.detach(), **om}
        return new_p, new_o, metrics

    structs = {"params": pstruct, "opt": ostruct, "batch": bstruct,
               "pspecs": None, "mesh": None}
    return step, structs

