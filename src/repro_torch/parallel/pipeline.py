"""SPMD pipeline parallelism: GPipe microbatch rotation across ranks.

Ports ``repro/parallel/pipeline.py``.  Layer params are stacked with
leading (stage, patterns_per_stage) dims and split over the "stage" mesh
axis; microbatch activations rotate between stages by a ``ppermute``.
Tensor parallelism runs inside each stage over the "tensor" axis; the
embedding and the head are vocab-parallel over ("stage", "tensor").  This
module builds the three steps: ``build_train_step``,
``build_prefill_step`` and ``build_decode_step``.

FlexPipe connection: ``PipelinePlan(stages, tensor, replica, microbatches)``
is the granularity the controller selects; a refactoring event calls these
builders again with a new plan.

Where the reference wraps a step in ``shard_map`` over a device mesh, the
port runs one process per rank (``launch.mesh``): a step takes and returns
this rank's local shards (``sharding.shard`` of the global trees by the
specs in ``structs``), binds the refined mesh for its collectives
(``parallel.comm``) and runs the same operations on every rank.  Whatever
depends on the rank's coordinate and feeds a collective goes through
``comm.where`` (the reference's ``jnp.where(stage_idx == ...)``), so
forward and backward issue the same collectives in the same order
everywhere; a rank-dependent Python branch only guards a cache write.
``base_mesh=None`` is one rank: every collective is the identity, and a
plan with S * T * R > 1 raises.

Differences in idiom: params are dicts of tensors; ``jax.checkpoint``
becomes ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
(at tick granularity, so FSDP's all-gathers run again inside the
backward); the donated params, optimizer moments and caches are updated
in place.  A layer writes its cache rows in place, so each tick runs a
stage on a copy of its microbatch's cache rows and copies them back only
where the tick is a real one (the reference's masked ``_mb_update``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (LayerKind, ModelConfig, PipelinePlan,
                                      ShapeConfig)
from repro_torch.models import layers as L
from repro_torch.models.kvcache import layer_shapes
from repro_torch.models.transformer import BlockCtx, apply_block, model_spec
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (DP_AXES, VP_AXES, P, apply_fsdp,
                                           fsdp_gather, local_shape,
                                           refine_mesh, stacked_param_specs)
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

f32 = torch.float32


# ---------------------------------------------------------------------------
# Param stacking
# ---------------------------------------------------------------------------

def _stack(xs):
    if xs[0].is_meta:
        # shapes only: torch.stack on meta tensors imports torch._dynamo,
        # seconds of a process's start
        return torch.empty((len(xs),) + tuple(xs[0].shape),
                           dtype=xs[0].dtype, device="meta")
    return torch.stack(xs)


def _tree_stack(trees):
    return tree_map(lambda *xs: _stack(xs), *trees)


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
# Vocab-parallel embed / head / cross-entropy
# ---------------------------------------------------------------------------

def _vp_rank(plan: PipelinePlan) -> int:
    """This rank's vocab shard over ("stage", "tensor")."""
    return comm.axis_index("stage") * plan.tensor + comm.axis_index("tensor")


def vp_embed(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
             tokens: torch.Tensor, pos0=0) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d); the embed table is this rank's vocab
    shard: each rank embeds the tokens it holds, and a psum over the vocab
    axes adds the shards."""
    emb = stacked["embed"]
    Vloc = emb.shape[0]
    lid = tokens.long() - _vp_rank(plan) * Vloc
    valid = (lid >= 0) & (lid < Vloc)
    x = emb[torch.clamp(lid, 0, Vloc - 1)] * valid[..., None].to(emb.dtype)
    x = comm.psum(x, VP_AXES)
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
    rank = _vp_rank(plan)
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
        m = comm.pmax(logits.max(dim=-1).values, VP_AXES)
        se = comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1), VP_AXES)
        lse = m + torch.log(se)
        lid = lb - rank * Vloc
        valid = (lid >= 0) & (lid < Vloc)
        ll = torch.gather(logits, -1,
                          torch.clamp(lid, 0, Vloc - 1)[..., None])[..., 0]
        ll = comm.psum(torch.where(valid, ll, torch.zeros_like(ll)), VP_AXES)
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
    """Apply one stage (pps repeating patterns).  ``stage_params`` and
    ``cache`` leaves have a leading (pps,) dim; the cache is written in
    place.  Returns (x, cache, aux_sum); with ``remat`` each pattern is
    recomputed in the backward pass.

    fsdp_dims: each leaf's all-gather dim (of a pattern's slice) where the
    params are split over "data" as well: a pattern's params are gathered
    just before use, inside any checkpoint around the call, so the backward
    gathers them again (ZeRO-3)."""
    kinds = _stage_kinds(cfg)
    tp = "tensor" if plan.tensor > 1 else None
    gd = torch.float8_e4m3fn if plan.fsdp_fp8_gather else None

    def pattern_body(x, params_p, cache_p):
        if fsdp_dims is not None:
            params_p = fsdp_gather(params_p, fsdp_dims, gather_dtype=gd)
        aux = torch.zeros((), dtype=f32, device=x.device)
        for j, kind in enumerate(kinds):
            ctx = BlockCtx(pos0=pos0,
                           cache=cache_p[str(j)] if cache_p is not None
                           else None,
                           memory=memory, is_global=cfg.is_global_layer(j),
                           causal=causal, tp_axis=tp, sp_axis=sp_axis)
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
        cache_p = (tree_map(lambda leaf: leaf[p], cache)
                   if cache is not None else None)
        if remat:
            x, a = checkpoint(pattern_body, x, params_p, cache_p,
                              use_reentrant=False)
        else:
            x, a = pattern_body(x, params_p, cache_p)
        auxs.append(a)
    return x, cache, torch.stack(auxs).sum()


def run_encoder_stacked(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                        frames: torch.Tensor, kv_block=1024) -> torch.Tensor:
    """Whisper's encoder (S=1) over the stacked encoder blocks, tensor
    parallel over "tensor" when T > 1."""
    tp = "tensor" if plan.tensor > 1 else None
    x = frames
    if cfg.rope_theta == 0 and "pos_embed" in stacked:
        x = x + stacked["pos_embed"][:x.shape[1]][None].to(x.dtype)
    kind = LayerKind()                 # the default attention / dense kind
    blocks = stacked["encoder"]["blocks"]
    for i in range(cfg.encoder_layers):
        bp = tree_map(lambda leaf: leaf[i], blocks)
        x, _, _ = apply_block(cfg, kind, bp, x,
                              BlockCtx(causal=False, tp_axis=tp))
    return L.rms_norm(stacked["encoder"]["final_norm"], x, cfg.rms_eps)


# ---------------------------------------------------------------------------
# Pipelined sequence pass (train forward / prefill)
# ---------------------------------------------------------------------------

def _rotate(x: torch.Tensor, plan: PipelinePlan) -> torch.Tensor:
    """Stage s's output goes to stage s + 1 (the last stage's to stage 0)."""
    if plan.stages == 1:
        return x
    perm = [(i, (i + 1) % plan.stages) for i in range(plan.stages)]
    return comm.ppermute(x, "stage", perm)


def _mb_slice(tree, mb: int, Bm: int):
    """A copy of microbatch ``mb``'s rows [mb*Bm, (mb+1)*Bm) on the batch
    dim (axis 1, after the leading pps dim) of every cache leaf: the
    stage's layers write into it in place."""
    return tree_map(lambda leaf: leaf[:, mb * Bm:(mb + 1) * Bm].clone(),
                    tree)


def _mb_update(tree, upd, mb: int, Bm: int, valid: bool) -> None:
    """Copy a microbatch's rows back where the tick is a real one (the
    reference's masked update; no collective depends on it)."""
    if valid:
        tree_map(lambda leaf, u: leaf[:, mb * Bm:(mb + 1) * Bm].copy_(u),
                 tree, upd)


def _squeeze_stage(stages_tree):
    """The local stage axis (size 1 per rank) -> squeezed leading dim."""
    return tree_map(lambda leaf: leaf[0], stages_tree)


def pipeline_seq_pass(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                      tokens: torch.Tensor, *, labels=None, caches=None,
                      memory_all=None, frames_all=None, kv_block=1024,
                      remat=False, fsdp_ctx=None):
    """Pipelined pass over full sequences (train forward or prefill).

    tokens (Bl, S) local batch; M = plan.microbatches must divide Bl.  The
    loop runs M + S - 1 ticks; at tick t stage 0 takes microbatch t, stage
    s runs microbatch t - s, and the last stage emits microbatch t - (S -
    1), broadcast to every stage by a psum.  With ``remat`` each tick is
    recomputed in the backward pass from its (small) carried state.
    ``caches``: leaves (pps, Bl, ...), the stage dim squeezed, written in
    place.  Returns a dict with loss_sum, token_count (if labels), aux,
    caches and last_logits (Bl, Vloc) (if caches)."""
    stacked = fsdp_gather_top(stacked, fsdp_ctx)
    stage_dims = fsdp_ctx["stages"] if fsdp_ctx is not None else None
    Bl, Sq = tokens.shape
    M = plan.microbatches
    if Bl % M:
        raise ValueError(f"batch {Bl} not divisible by M={M} microbatches")
    Bm = Bl // M
    S_st = plan.stages
    stage_idx = comm.axis_index("stage")
    d = cfg.d_model
    dt = stacked["embed"].dtype
    dev = tokens.device
    stage_params = _squeeze_stage(stacked["stages"])
    Vloc = stacked["embed"].shape[0]

    toks = tokens.reshape(M, Bm, Sq)
    labs = labels.reshape(M, Bm, Sq) if labels is not None else None
    n_ticks = M + S_st - 1
    last_logits = (torch.zeros((Bl, Vloc), dtype=f32, device=dev)
                   if caches is not None else None)

    def tick(t, state, loss_sum, tok_count, aux_sum):
        mb_in = min(max(t, 0), M - 1)
        x_in = vp_embed(cfg, plan, stacked, toks[mb_in])
        # this rank's CURRENT microbatch (for cache slicing and memory)
        mb_cur = min(max(t - stage_idx, 0), M - 1)
        valid_cur = 0 <= t - stage_idx < M
        state = comm.where(stage_idx == 0, x_in.to(dt), state)

        memory = None
        if memory_all is not None:
            memory = memory_all[mb_cur]
        if frames_all is not None:
            memory = run_encoder_stacked(cfg, plan, stacked,
                                         frames_all[mb_cur], kv_block)

        cache_mb = _mb_slice(caches, mb_cur, Bm) if caches is not None \
            else None
        out, cache_mb, aux = run_stage(
            cfg, plan, stage_params, state, cache_mb, pos0=0, memory=memory,
            causal=True, kv_block=kv_block, remat=False,
            fsdp_dims=stage_dims)
        aux_sum = aux_sum + comm.where(valid_cur, aux, torch.zeros_like(aux))
        if caches is not None:
            _mb_update(caches, cache_mb, mb_cur, Bm, valid_cur)

        # emission from the last stage (the same ticks on every rank)
        mb_out = min(max(t - (S_st - 1), 0), M - 1)
        emit = t >= S_st - 1 and t - (S_st - 1) < M
        out_b = comm.psum(comm.where(stage_idx == S_st - 1, out,
                                     torch.zeros_like(out)), "stage") \
            if S_st > 1 else out
        if labs is not None and emit:
            nll, cnt = vp_cross_entropy(cfg, plan, stacked, out_b,
                                        labs[mb_out])
            loss_sum = loss_sum + nll
            tok_count = tok_count + cnt
        if last_logits is not None and emit:
            lg = vp_logits(cfg, stacked, out_b[:, -1:, :])[:, 0, :]
            last_logits[mb_out * Bm:(mb_out + 1) * Bm] = lg
        return _rotate(out, plan), loss_sum, tok_count, aux_sum

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
            "caches": caches, "last_logits": last_logits}


# ---------------------------------------------------------------------------
# FSDP plumbing
# ---------------------------------------------------------------------------

def fsdp_transform(plan: PipelinePlan, pstruct: dict, pspecs: dict,
                   data_size: int):
    """Split the FSDP spec rewrite between the stage-stacked leaves
    (min_dim=2: never the (S, pps) dims) and the top-level ones.

    Returns (new_pspecs, fsdp_ctx): fsdp_ctx = {"top": dims over the
    entries other than "stages", "stages": dims of a pattern's slice of
    each stage leaf}, or None without FSDP."""
    if not plan.fsdp:
        return pspecs, None
    new_specs = dict(pspecs)
    st_specs, st_dims = apply_fsdp(pspecs["stages"], pstruct["stages"],
                                   data_size, min_dim=2)
    new_specs["stages"] = st_specs
    top_dims = {}
    for k in pstruct:
        if k == "stages":
            continue
        min_dim = 1 if k == "encoder" else 0
        sp, dims = apply_fsdp(pspecs[k], pstruct[k], data_size, min_dim)
        new_specs[k] = sp
        top_dims[k] = dims
    stage_dims = tree_map(lambda dd: dd - 2 if dd >= 2 else -1, st_dims)
    return new_specs, {"top": top_dims, "stages": stage_dims}


def fsdp_gather_top(stacked: dict, fsdp_ctx):
    """Gather the non-stage params (embed, head, norms, encoder) once per
    step."""
    if fsdp_ctx is None:
        return stacked
    out = dict(stacked)
    for k, dims in fsdp_ctx["top"].items():
        out[k] = fsdp_gather(stacked[k], dims)
    return out


# ---------------------------------------------------------------------------
# Pipelined decode pass
# ---------------------------------------------------------------------------

def pipeline_decode_pass(cfg: ModelConfig, plan: PipelinePlan, stacked: dict,
                         tokens: torch.Tensor, caches, pos, *, kv_block=1024,
                         fsdp_ctx=None):
    """One token for every request.  tokens (Bl, 1); caches leaves (pps,
    Bl, ...) local, written in place; pos: the cache length (an int).
    Returns (logits (Bl, Vloc), caches)."""
    stacked = fsdp_gather_top(stacked, fsdp_ctx)
    stage_dims = fsdp_ctx["stages"] if fsdp_ctx is not None else None
    Bl = tokens.shape[0]
    M = plan.microbatches
    Bm = Bl // M
    S_st = plan.stages
    stage_idx = comm.axis_index("stage")
    dt = stacked["embed"].dtype
    sp_axis = "data" if plan.seq_parallel_kv else None
    stage_params = _squeeze_stage(stacked["stages"])
    toks = tokens.reshape(M, Bm, 1)
    Vloc = stacked["embed"].shape[0]
    logits = torch.zeros((Bl, Vloc), dtype=f32, device=tokens.device)
    state = torch.zeros((Bm, 1, cfg.d_model), dtype=dt, device=tokens.device)
    for t in range(M + S_st - 1):
        mb_in = min(max(t, 0), M - 1)
        x_in = vp_embed(cfg, plan, stacked, toks[mb_in], pos0=pos)
        state = comm.where(stage_idx == 0, x_in.to(dt), state)
        mb_cur = min(max(t - stage_idx, 0), M - 1)
        valid_cur = 0 <= t - stage_idx < M

        cache_mb = _mb_slice(caches, mb_cur, Bm)
        out, cache_mb, _ = run_stage(
            cfg, plan, stage_params, state, cache_mb, pos0=pos, causal=True,
            sp_axis=sp_axis, kv_block=kv_block, fsdp_dims=stage_dims)
        _mb_update(caches, cache_mb, mb_cur, Bm, valid_cur)

        mb_out = min(max(t - (S_st - 1), 0), M - 1)
        emit = t >= S_st - 1 and t - (S_st - 1) < M
        out_b = comm.psum(comm.where(stage_idx == S_st - 1, out,
                                     torch.zeros_like(out)), "stage") \
            if S_st > 1 else out
        if emit:
            logits[mb_out * Bm:(mb_out + 1) * Bm] = \
                vp_logits(cfg, stacked, out_b)[:, 0, :]
        state = _rotate(out, plan)
    return logits, caches


# ---------------------------------------------------------------------------
# Stacked cache structs & specs
# ---------------------------------------------------------------------------

def stacked_cache_struct(cfg: ModelConfig, plan: PipelinePlan,
                         shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """The global caches as meta tensors: {j: leaves (S, pps, B, ...)}."""
    S = plan.stages
    pps = cfg.n_patterns // S
    return {str(j): {part: {name: torch.empty((S, pps) + shp, dtype=dtype,
                                              device="meta")
                            for name, shp in leaves.items()}
                     for part, leaves in layer_shapes(
                         cfg, j, shape.global_batch, shape.seq_len).items()}
            for j in range(cfg.pattern_size)}


def stacked_cache_specs(cfg: ModelConfig, plan: PipelinePlan,
                        shape: ShapeConfig, cache_tree) -> dict:
    """Specs congruent with ``stacked_cache_struct``."""
    sp = plan.seq_parallel_kv
    T = plan.tensor

    def spec_for(j, part, name, leaf):
        nd = len(leaf.shape)
        dims: list = [None] * nd
        dims[0] = "stage"
        dims[2] = _dp_entry(shape, plan)
        if name in ("k", "v"):
            is_window = (cfg.sliding_window and not cfg.is_global_layer(j)
                         and part != "cross")
            if T > 1 and leaf.shape[3] % T == 0:
                dims[3] = "tensor"
            if sp and not is_window and part != "cross":
                dims[4] = "data"
        elif name in ("latent", "k_rope"):
            if sp:
                dims[3] = "data"
        elif name in ("ssm", "wkv"):
            if T > 1 and leaf.shape[3] % T == 0:
                dims[3] = "tensor"
        elif name == "conv":
            if T > 1 and leaf.shape[4] % T == 0:
                dims[4] = "tensor"
        # sx_tm / sx_cm: whole beyond batch and stage
        return P(*dims)

    return {j: {part: {name: spec_for(int(j), part, name, leaf)
                       for name, leaf in leaves.items()}
                for part, leaves in layer.items()}
            for j, layer in cache_tree.items()}


# ---------------------------------------------------------------------------
# Gradient synchronization
# ---------------------------------------------------------------------------

ALL_AXES = ("pod", "data", "stage", "tensor", "replica")


def _size(mesh, axis: str) -> int:
    return mesh.size(axis) if mesh is not None else 1


def grad_sync(grads, pspecs, mesh, compress_pod: bool = False):
    """psum each gradient leaf over every mesh axis it is whole on.

    With ``compress_pod`` the cross-pod part of the sum is the int8
    all-reduce of ``training.compression.compressed_psum``."""
    from repro_torch.training.compression import compressed_psum

    def sync(g, spec):
        missing = tuple(a for a in ALL_AXES
                        if a not in spec.axes() and _size(mesh, a) > 1)
        if not missing:
            return g
        if compress_pod and "pod" in missing:
            rest = tuple(a for a in missing if a != "pod")
            if rest:
                g = comm.psum(g, rest)
            return compressed_psum(g, "pod")
        return comm.psum(g, missing)

    return tree_unflatten(tree_flatten(grads)[1],
                          [sync(g, s) for g, s in zip(tree_leaves(grads),
                                                      tree_leaves(pspecs))])


def grad_norm_sq(grads, pspecs, mesh) -> torch.Tensor:
    """The exact global ||g||^2 of a tree of split and whole leaves: each
    leaf's sum of squares divided by the ranks it is repeated on along
    (stage, tensor, data), then psummed over those axes."""
    leaves = tree_leaves(grads)
    total = torch.zeros((), dtype=f32, device=leaves[0].device)
    for g, spec in zip(leaves, tree_leaves(pspecs)):
        rep = 1
        for a in ("stage", "tensor", "data"):
            if a not in spec.axes():
                rep *= _size(mesh, a)
        total = total + torch.sum(torch.square(g.float())) / rep
    return comm.psum(total, ("stage", "tensor", "data"))


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def _cache_squeeze(tree):
    return tree_map(lambda leaf: leaf[0], tree)


def _cache_unsqueeze(tree):
    return tree_map(lambda leaf: leaf[None], tree)


def _dp_entry(shape: ShapeConfig, plan: PipelinePlan):
    """The batch dim's split: DP_AXES when the global batch divides the
    worst-case (multi-pod) dp degree, else whole (e.g. batch-1 decode)."""
    if plan.seq_parallel_kv or shape.global_batch % (32 * plan.replica) != 0:
        return None
    return DP_AXES


def _batch_in_specs(cfg: ModelConfig, shape: ShapeConfig,
                    plan: PipelinePlan) -> dict:
    """Specs of the step's batch dict, given the arch's extras."""
    dp = _dp_entry(shape, plan)
    specs = {"tokens": P(dp, None)}
    if shape.kind == "train":
        specs["labels"] = P(dp, None)
    if cfg.encoder_layers and shape.kind != "decode":
        specs["frames"] = P(dp, None, None)
    if cfg.n_memory_tokens and not cfg.encoder_layers \
            and shape.kind != "decode":
        specs["memory"] = P(dp, None, None)
    return specs


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


def _mesh_for(plan: PipelinePlan, base_mesh):
    """The refined mesh, or None (one rank) where ``base_mesh`` is None."""
    if base_mesh is None:
        if plan.model_axis > 1:
            raise ValueError(
                f"a plan with S*T*R = {plan.model_axis} (S={plan.stages}, "
                f"T={plan.tensor}, R={plan.replica}) needs a mesh of ranks "
                "(launch.mesh.make_local_mesh)")
        return None
    return refine_mesh(base_mesh, plan)


def _param_layout(cfg: ModelConfig, plan: PipelinePlan, mesh, param_dtype):
    pstruct = stacked_param_struct(cfg, plan, param_dtype)
    pspecs = stacked_param_specs(cfg, plan, pstruct)
    pspecs, fsdp_ctx = fsdp_transform(plan, pstruct, pspecs,
                                      _size(mesh, "data"))
    return pstruct, pspecs, fsdp_ctx


def _microbatched(batch: dict, M: int):
    frames_all = memory_all = None
    Bm = batch["tokens"].shape[0] // M
    if "frames" in batch:
        f = batch["frames"]
        frames_all = f.reshape(M, Bm, *f.shape[1:])
    if "memory" in batch:
        m = batch["memory"]
        memory_all = m.reshape(M, Bm, *m.shape[1:])
    return frames_all, memory_all


def build_train_step(cfg: ModelConfig, plan: PipelinePlan, base_mesh,
                     shape: ShapeConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                     param_dtype=torch.bfloat16, compress_pod: bool = False,
                     aux_weight: float = 0.01):
    """Returns (step, structs): ``step(params, opt, batch)`` gives (params,
    opt, {"loss", "aux", "grad_norm", "lr"}) from this rank's local params,
    moments and batch (``sharding.shard`` by ``structs["pspecs"]`` and
    ``structs["bspecs"]``), both updated in place.  ``base_mesh``: a
    ``launch.mesh`` (data, model) or (pod, data, model) mesh whose model
    axis the plan fills, or None for one rank."""
    mesh = _mesh_for(plan, base_mesh)
    pstruct, pspecs, fsdp_ctx = _param_layout(cfg, plan, mesh, param_dtype)
    ostruct = OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(lambda s: torch.empty(s.shape, dtype=f32, device="meta"),
                   pstruct),
        v=tree_map(lambda s: torch.empty(s.shape, dtype=f32, device="meta"),
                   pstruct))
    ospecs = OptState(step=P(), m=pspecs, v=pspecs)
    bspecs = _batch_in_specs(cfg, shape, plan)
    bstruct = batch_struct(cfg, shape, plan, param_dtype)
    M = plan.microbatches

    def step(params, opt_state, batch):
        with comm.bind(mesh):
            leaves, treedef = tree_flatten(params)
            diff = [leaf.detach().requires_grad_(True) for leaf in leaves]
            p = tree_unflatten(treedef, diff)
            frames_all, memory_all = _microbatched(batch, M)
            with torch.enable_grad():
                res = pipeline_seq_pass(
                    cfg, plan, p, batch["tokens"], labels=batch["labels"],
                    frames_all=frames_all, memory_all=memory_all,
                    remat=plan.remat, fsdp_ctx=fsdp_ctx)
                loss = comm.psum(res["loss_sum"], DP_AXES) / torch.clamp(
                    comm.psum(res["token_count"], DP_AXES), min=1.0)
                aux = comm.psum(res["aux"], ("stage",)) \
                    / max(M * cfg.n_layers, 1)
                total = loss + aux_weight * aux
                grads = torch.autograd.grad(total, diff, allow_unused=True)
            grads = tree_unflatten(treedef, [
                torch.zeros_like(x) if g is None else g
                for g, x in zip(grads, leaves)])
            grads = grad_sync(grads, pspecs, mesh, compress_pod)
            nsq = grad_norm_sq(grads, pspecs, mesh)
            new_p, new_o, om = adamw_update(opt_cfg, params, grads,
                                            opt_state, extra_norm_sq=nsq)
        metrics = {"loss": loss.detach(), "aux": aux.detach(), **om}
        return new_p, new_o, metrics

    structs = {"params": pstruct, "opt": ostruct, "batch": bstruct,
               "pspecs": pspecs, "ospecs": ospecs, "bspecs": bspecs,
               "mesh": mesh}
    return step, structs


def _cache_dtype(plan: PipelinePlan, cache_dtype):
    if cache_dtype is not None:
        return cache_dtype
    return torch.float8_e4m3fn if plan.kv_dtype == "fp8" else torch.bfloat16


def build_prefill_step(cfg: ModelConfig, plan: PipelinePlan, base_mesh,
                       shape: ShapeConfig, param_dtype=torch.bfloat16,
                       cache_dtype=None):
    """Returns (step, structs): ``step(params, batch)`` gives (last_logits
    (Bl, Vloc), caches) at this rank: its vocab shard of each request's
    last logits (spec ``structs["lspec"]``) and its local caches, leaves
    (1, pps, B, ...) of the global ``structs["cache"]`` by
    ``structs["cspecs"]``."""
    cache_dtype = _cache_dtype(plan, cache_dtype)
    mesh = _mesh_for(plan, base_mesh)
    pstruct, pspecs, fsdp_ctx = _param_layout(cfg, plan, mesh, param_dtype)
    cstruct = stacked_cache_struct(cfg, plan, shape, cache_dtype)
    cspecs = stacked_cache_specs(cfg, plan, shape, cstruct)
    bspecs = _batch_in_specs(cfg, shape, plan)
    bstruct = batch_struct(cfg, shape, plan, param_dtype)
    M = plan.microbatches

    def step(params, batch):
        with comm.bind(mesh), torch.no_grad():
            dev = batch["tokens"].device
            frames_all, memory_all = _microbatched(batch, M)
            caches = {j: {part: {
                name: torch.zeros(local_shape(leaf.shape, cspecs[j][part][
                    name], mesh)[1:] if mesh is not None
                    else tuple(leaf.shape)[1:], dtype=leaf.dtype, device=dev)
                for name, leaf in leaves.items()}
                for part, leaves in layer.items()}
                for j, layer in cstruct.items()}
            res = pipeline_seq_pass(cfg, plan, params, batch["tokens"],
                                    caches=caches, frames_all=frames_all,
                                    memory_all=memory_all, fsdp_ctx=fsdp_ctx)
        return res["last_logits"], _cache_unsqueeze(res["caches"])

    structs = {"params": pstruct, "batch": bstruct, "cache": cstruct,
               "pspecs": pspecs, "cspecs": cspecs, "bspecs": bspecs,
               "lspec": P(_dp_entry(shape, plan), VP_AXES), "mesh": mesh}
    return step, structs


def build_decode_step(cfg: ModelConfig, plan: PipelinePlan, base_mesh,
                      shape: ShapeConfig, param_dtype=torch.bfloat16,
                      cache_dtype=None):
    """Returns (step, structs): ``step(params, caches, tokens, pos)`` gives
    (logits (Bl, Vloc), caches) at this rank, the caches (leaves (1, pps,
    B, ...), as the prefill step returns them) written in place; ``pos``
    is the cache length, an int."""
    cache_dtype = _cache_dtype(plan, cache_dtype)
    mesh = _mesh_for(plan, base_mesh)
    pstruct, pspecs, fsdp_ctx = _param_layout(cfg, plan, mesh, param_dtype)
    cstruct = stacked_cache_struct(cfg, plan, shape, cache_dtype)
    cspecs = stacked_cache_specs(cfg, plan, shape, cstruct)
    dp = _dp_entry(shape, plan)

    def step(params, caches, tokens, pos):
        with comm.bind(mesh), torch.no_grad():
            logits, _ = pipeline_decode_pass(
                cfg, plan, params, tokens, _cache_squeeze(caches), int(pos),
                fsdp_ctx=fsdp_ctx)
        return logits, caches

    structs = {"params": pstruct, "cache": cstruct,
               "tokens": torch.empty((shape.global_batch, 1),
                                     dtype=torch.int32, device="meta"),
               "pspecs": pspecs, "cspecs": cspecs, "tspec": P(dp, None),
               "lspec": P(dp, VP_AXES), "mesh": mesh}
    return step, structs
