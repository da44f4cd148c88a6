"""Core layers of the serving path: RMSNorm, RoPE, GQA attention (global
and sliding-window), gated cross attention, multi-head latent attention
(MLA), SwiGLU, GeGLU and the plain gelu MLP, and top-k mixture of experts.

Ports the main-path subset of ``repro/models/layers.py`` with the same
param layout (``wq (d, H, hd)``, ``wk/wv (d, Kh, hd)``, ``wo (H, hd, d)``,
``bq/bk/bv``) and cache layout (dense ``(B, Kh, Smax, hd)`` rows, paged
``(n_blocks, Kh, block_size, hd)`` pools).

Caches are written in place: where the JAX package donates a cache and
returns a new one, these functions write the new rows into the tensors
they were given and return the same dict.  Attention goes through the
kernel wrappers, which take their plain versions for CPU tensors and launch
the CUDA kernels for CUDA tensors.

Chunked prefill (``kv_extent``) writes a chunk's rows at ``pos0`` and
attends over cache rows ``[0, kv_extent)`` through the flash kernel with
``q_offset = pos0``.  The cache is head-major ``(B, Kh, Smax, hd)`` and the
kernel takes ``(B, Skv, Kh, hd)``, so each chunk makes one transposing copy
of ``kv_extent`` rows per layer (a gather through the table when paged).

A sliding-window (local) layer keeps a ring of ``Smax = min(max_seq,
window)`` rows: position p lives at row ``p % Smax``.  Decode writes there
and attends over ``min(pos0 + 1, Smax)`` rows (every row once the ring has
wrapped, which is exactly the window when ``Smax == window``); a prefill of
``S >= Smax`` tokens keeps the last ``Smax`` rows, rolled into place; the
prefill itself attends over the fresh k/v through the windowed flash
kernel.  Rows past ``pos0 + 1`` in an unwrapped ring are never read, so a
reused slot's stale rows do no harm.  Paged and chunked paths are global
only, as in the reference.

The MoE layer routes as the reference's ``apply_moe`` does (f32 router
logits, softmax, top-k renormalised, a Switch aux loss, each (token, k)
assignment queued in (token, k) order and kept while its queue position is
below ``cap = max(ceil(T k / E cf), 4)``, T counting every row of the
call), but dispatches and combines through indices instead of the
reference's ``(T, E, cap)`` one-hot einsums: the kept rows are copied into
an ``(E, cap, d)`` buffer, the experts run as three ``torch.bmm`` calls,
and each token gathers its kept rows back and sums them in k order.  The
shared experts are added after the combine.

Cross attention (llama-3.2-vision's gated image layers, whisper's decoder)
attends from x to ``memory`` tokens ``(B, M, d)``, or, given no memory, to
the K/V its cache holds.  A single query row goes through the decode
kernel with ``cache_len = M``, longer inputs through the flash kernel with
``causal=False``; the output enters the residual through ``tanh(gate)``.

MLA (DeepSeek-V2) caches a per-token latent and one shared rotary key
head, ``(B, Smax, r)`` and ``(B, Smax, rd)``.  A prompt materializes K and
V from its latent and goes through the flash kernel at (hd, hdv) = (nd +
rd, vd); decode stays in the reference's absorbed form, torch products in
f32 (``mla_absorbed_decode``), which no kernel of the JAX package covers.

Tensor parallelism (``tp_axis``, a mesh axis name; ``parallel.comm``):
params are a rank's shards, and every shape is read from them, so a layer
runs its H/T local heads (through the same kernels: their G only shrinks),
its ff/T columns or its E/T local experts, and the output projection's
partial sums are psummed over the axis.  Where the q heads cannot split
(``sharding._attn_heads_shardable``) every rank computes all of them and
the psum is divided by T.  An expert-parallel MoE routes over all E
experts on every rank, runs the assignments of its own E/T experts and
psums the combined output; its aux loss is psummed and divided by T.
Sequence-parallel decode (``sp_axis``) keeps a global-attention cache's
rows split over the axis: the owner of row ``pos0`` writes it, and each
rank attends over its rows in f32 torch products, combined with a
log-sum-exp psum (the reference's jnp path; no kernel takes partial
softmax statistics).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  gather_pages,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel import comm

Params = dict


def _maybe_psum(x: torch.Tensor, tp_axis) -> torch.Tensor:
    return comm.psum(x, tp_axis) if tp_axis else x


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    # a Python-scalar base: a tensor made from theta on the card would be a
    # host-to-device copy, which waits for the stream, in every layer
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return 1.0 / torch.pow(float(theta), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, hd); positions: (seq,) or (batch, seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions.float()[..., :, None] * freqs             # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(params: Params, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def positions(pos0, S: int, device) -> torch.Tensor:
    """Absolute positions: (S,) for a scalar pos0, (B, S) for a per-slot
    vector.  A Python int is not copied to the device (that copy would
    wait for the stream in every layer)."""
    if torch.is_tensor(pos0):
        ar = torch.arange(S, device=pos0.device)
        return (pos0[:, None] + ar) if pos0.ndim == 1 else pos0 + ar
    return torch.arange(int(pos0), int(pos0) + S, device=device)


def _dense_rows(c: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Rows [0, n) of a head-major cache, as the flash kernel's contiguous
    ``(B, n, Kh, hd)`` (one transposing copy)."""
    return c[:, :, :n].transpose(1, 2).to(dtype).contiguous()


def _paged_rows(pool: torch.Tensor, ids: torch.Tensor, n: int,
                dtype) -> torch.Tensor:
    """Rows [0, n) of one slot's logical view, its blocks ``ids`` gathered
    from the pool, as the flash kernel's contiguous ``(1, n, Kh, hd)``."""
    nb, Kh, bs, hd = ids.shape[0], pool.shape[1], pool.shape[2], pool.shape[3]
    g = pool[ids].permute(0, 2, 1, 3).reshape(1, nb * bs, Kh, hd)
    return g[:, :n].to(dtype).contiguous()


def _paged_attention(q, k, v, cache, block_table, *, pos0, wo, causal,
                     paged_kernel, kv_extent=0):
    """Attention over block pools and per-slot block tables.

    Decode (S == 1) writes each slot's new row into its tail block and
    attends over its table; idle slots (all-null tables) write into the
    null block 0, which no masked read sees.  Prefill (S > 1, batch 1) writes
    the whole prompt through the table and attends over the fresh k/v, as
    the dense path does; bucket padding past the slot's blocks lands in the
    null block."""
    B, S, H, hd = q.shape
    kp, vp = cache["k"], cache["v"]
    bs = kp.shape[2]
    km = k.movedim(1, 2).to(kp.dtype)                  # (B, Kh, S, hd)
    vm = v.movedim(1, 2).to(vp.dtype)
    bt = block_table
    if S == 1:
        p0 = torch.as_tensor(pos0, device=q.device).reshape(-1).expand(B)
        p0 = p0.long()
        pid = bt[torch.arange(B, device=q.device), p0 // bs].long()
        off = p0 % bs
        kp[pid, :, off, :] = km[:, :, 0, :]             # (B, Kh, hd)
        vp[pid, :, off, :] = vm[:, :, 0, :]
        if paged_kernel:
            out = paged_decode_attention(q[:, 0].contiguous(), kp, vp,
                                         bt.to(torch.int32).contiguous(),
                                         p0 + 1)
        else:
            # the gathered logical view has a dense cache's shape and
            # masking, so its outputs are bit-identical to the dense layout
            out = decode_attention(q[:, 0].contiguous(), gather_pages(kp, bt),
                                   gather_pages(vp, bt), p0 + 1)
        out = out[:, None]
    else:
        if B != 1:
            raise ValueError("paged prefill runs one slot at a time")
        p0 = int(torch.as_tensor(pos0).reshape(-1)[0])
        pos = p0 + torch.arange(S, device=q.device)
        pids = bt[0, pos // bs].long()
        offs = pos % bs
        kp[pids, :, offs, :] = km[0].movedim(0, 1)      # (S, Kh, hd)
        vp[pids, :, offs, :] = vm[0].movedim(0, 1)
        if kv_extent:
            ids = bt[0, :-(-kv_extent // bs)].long()
            out = flash_attention(q.contiguous(),
                                  _paged_rows(kp, ids, kv_extent, q.dtype),
                                  _paged_rows(vp, ids, kv_extent, q.dtype),
                                  causal=causal, q_offset=p0)
        else:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, q_offset=0)
    y = torch.einsum("bshk,hkd->bsd", out, wo)
    return y, cache


def apply_attention(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                    pos0, cache=None, is_global: bool = True,
                    causal: bool = True, tp_axis=None, sp_axis=None,
                    block_table=None, paged_kernel: bool = False,
                    kv_extent: int = 0):
    """Self attention: prefill (cache None or being filled) or decode.

    pos0: absolute position of x[:, 0]; an int, or for ragged decode a
    (B,) tensor of per-slot positions.  cache: None or dict(k, v),
    head-major, written in place.  block_table: paged KV, (B, M) physical
    block ids per slot; ``paged_kernel`` picks the block-walk kernel over
    the gather path.  Returns (y, cache, aux)."""
    B, S, _ = x.shape
    window = 0 if is_global else cfg.sliding_window
    q, k, v = _qkv(params, x)
    if cfg.rope_theta:
        pos = positions(pos0, S, x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if block_table is not None and cache is not None:
        y, cache = _paged_attention(q, k, v, cache, block_table, pos0=pos0,
                                    wo=params["wo"], causal=causal,
                                    paged_kernel=paged_kernel,
                                    kv_extent=kv_extent)
        return _maybe_psum(y, tp_axis), cache, aux

    if sp_axis is not None and not window and S == 1 and cache is not None:
        for name, t in (("k", k), ("v", v)):
            sp_cache_write(cache[name], t.movedim(1, 2), pos0, sp_axis)
        out = sp_decode_attention(q, cache["k"], cache["v"], pos0, sp_axis)
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
        return _maybe_psum(y, tp_axis), cache, aux

    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        Smax = kc.shape[2]
        km = k.movedim(1, 2).to(kc.dtype)              # (B, Kh, S, hd)
        vm = v.movedim(1, 2).to(vc.dtype)
        pos_vec = torch.is_tensor(pos0) and pos0.ndim == 1
        if S == 1 and pos_vec:
            # ragged decode: one write row per slot (continuous batching)
            bi = torch.arange(B, device=x.device)
            slots = (pos0 % Smax if window else pos0).long()
            kc[bi, :, slots, :] = km[:, :, 0, :]         # (B, Kh, hd)
            vc[bi, :, slots, :] = vm[:, :, 0, :]
        elif S == 1:
            p = int(pos0) % Smax if window else int(pos0)
            kc[:, :, p:p + 1] = km
            vc[:, :, p:p + 1] = vm
        elif kv_extent:
            p = int(pos0)                  # a chunk: rows [p, p + S)
            kc[:, :, p:p + S] = km
            vc[:, :, p:p + S] = vm
        elif S >= Smax:
            # a prompt at least as long as the ring: keep its last Smax
            # rows, rolled so that position p sits at row p % Smax
            kc.copy_(torch.roll(km[:, :, -Smax:], S % Smax, dims=2))
            vc.copy_(torch.roll(vm[:, :, -Smax:], S % Smax, dims=2))
        else:
            kc[:, :, :S] = km
            vc[:, :, :S] = vm

    if S == 1 and cache is not None:
        # the rows to read: [0, pos0] until a ring wraps, then all of it
        if torch.is_tensor(pos0):
            cl = torch.clamp(pos0 + 1, max=Smax) if window else pos0 + 1
        else:
            cl = min(int(pos0) + 1, Smax) if window else int(pos0) + 1
        out = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                               cl)[:, None]
    elif kv_extent and cache is not None:
        out = flash_attention(q.contiguous(),
                              _dense_rows(cache["k"], kv_extent, q.dtype),
                              _dense_rows(cache["v"], kv_extent, q.dtype),
                              causal=causal, window=window,
                              q_offset=int(pos0))
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, q_offset=0)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return _heads_psum(cfg, params, y, tp_axis), cache, aux


def _heads_psum(cfg: ModelConfig, params: Params, y: torch.Tensor, tp_axis):
    """The output projection's psum over ``tp_axis``; where the q heads did
    not split, every rank computed all of them, and the sum is divided by
    the axis size (small models on wide tensor axes)."""
    y = _maybe_psum(y, tp_axis)
    if tp_axis is not None and params["wq"].shape[-2] == cfg.n_heads:
        y = y / comm.axis_size(tp_axis)
    return y


def sp_decode_attention(q: torch.Tensor, k_loc: torch.Tensor,
                        v_loc: torch.Tensor, pos, axis: str, scale=None):
    """Sequence-parallel decode attention (flash-decode across ranks): the
    cache's rows are split over mesh axis ``axis``; each rank attends over
    its ``Sloc`` rows (global rows ``r * Sloc + j``, those <= ``pos``) and
    the partials combine through a pmax and two psums.  q (B, 1, H, hd);
    k_loc, v_loc (B, Kh, Sloc, hd).  f32 torch products, as the reference's
    jnp."""
    B, _, H, hd = q.shape
    Kh, Sloc = k_loc.shape[1], k_loc.shape[2]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    r = comm.axis_index(axis)
    qf = (q.float() * scale).reshape(B, Kh, G, hd)
    s = torch.einsum("bhgk,bhjk->bhgj", qf, k_loc.float())
    gpos = r * Sloc + torch.arange(Sloc, device=q.device)
    mask = (gpos <= int(pos))[None, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    m = comm.pmax(s.max(dim=-1).values, axis)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l_sum = comm.psum(p.sum(dim=-1), axis)
    o = comm.psum(torch.einsum("bhgj,bhjk->bhgk", p, v_loc.float()), axis)
    out = o / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def sp_cache_write(cache_leaf: torch.Tensor, update: torch.Tensor, pos,
                   axis: str) -> torch.Tensor:
    """Write one decode row ``update`` (B, Kh, 1, hd) into a cache whose
    rows are split over ``axis`` (B, Kh, Sloc, hd), in place: only the rank
    owning global row ``pos`` writes it (the others rewrite their row 0
    with its own value, as the reference's masked update does)."""
    Sloc = cache_leaf.shape[2]
    owner = int(pos) // Sloc
    if comm.axis_index(axis) == owner:
        cache_leaf[:, :, int(pos) - owner * Sloc] = \
            update[:, :, 0].to(cache_leaf.dtype)
    return cache_leaf


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

def apply_cross_attention(cfg: ModelConfig, params: Params, x: torch.Tensor,
                          *, memory=None, cache=None, tp_axis=None):
    """Cross attention from x to ``memory`` tokens (B, M, d), a frontend's
    precomputed image tokens or the encoder's output.

    With ``memory``, K and V are projected from it and, when ``cache``
    (dict k, v, head-major ``(B, Kh, M, hd)``) is given, written into it in
    place (a memory of another length replaces the cache's tensors, as
    the reference's returned cache does); without, they are read from the
    cache.  One query row takes the decode kernel over all M rows, longer
    inputs the flash kernel, non-causal.  Returns (y, cache, aux)."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cache is not None and memory is None:
        k_hm, v_hm = cache["k"], cache["v"]
        k = v = None
    else:
        memory = memory.to(params["wk"].dtype)
        k = torch.einsum("bmd,dhk->bmhk", memory, params["wk"])
        v = torch.einsum("bmd,dhk->bmhk", memory, params["wv"])
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k_hm, v_hm = k.movedim(1, 2), v.movedim(1, 2)
        if cache is not None:
            for name, t in (("k", k_hm), ("v", v_hm)):
                if cache[name].shape == t.shape:
                    cache[name].copy_(t)
                else:
                    cache[name] = t.to(cache[name].dtype).contiguous()
    M = k_hm.shape[2]
    if S == 1:
        out = decode_attention(q[:, 0].contiguous(), k_hm.contiguous(),
                               v_hm.contiguous(), M)[:, None]
    else:
        if k is None:
            k, v = (t.transpose(1, 2).to(q.dtype) for t in (k_hm, v_hm))
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=False, q_offset=0)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    y = y * torch.tanh(params["gate"].float()).to(y.dtype)
    return (_heads_psum(cfg, params, y, tp_axis), cache,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_spec(cfg: ModelConfig) -> dict:
    """Param tree of one MLA mixer as (shape, init) leaves, with the scales
    of ``repro.models.layers.init_mla``: low-rank query ``wq_down (d, rq)``,
    ``wq_up (rq, H, nd + rd)``; the shared down projection ``wkv_down (d,
    r + rd)`` to the latent and the rotary key; ``wk_up (r, H, nd)``,
    ``wv_up (r, H, vd)``, ``wo (H, vd, d)``; the two latents' norms."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    s = 1.0 / math.sqrt(d)
    sl = 1.0 / math.sqrt(m.kv_lora_rank)
    sq = 1.0 / math.sqrt(m.q_lora_rank)
    return {
        "wq_down": ((d, m.q_lora_rank), s),
        "wq_up": ((m.q_lora_rank, H, m.nope_head_dim + m.rope_head_dim), sq),
        "wkv_down": ((d, m.kv_lora_rank + m.rope_head_dim), s),
        "wk_up": ((m.kv_lora_rank, H, m.nope_head_dim), sl),
        "wv_up": ((m.kv_lora_rank, H, m.v_head_dim), sl),
        "wo": ((H, m.v_head_dim, d), s / math.sqrt(2 * cfg.n_layers)),
        "q_norm": ((m.q_lora_rank,), "ones"),
        "kv_norm": ((m.kv_lora_rank,), "ones"),
    }


def mla_absorbed_decode(q_nope, q_rope, latent, k_rope, wk_up, wv_up, pos0,
                        scale: float) -> torch.Tensor:
    """One query row per slot against the latent cache, in the absorbed
    form and in f32: ``q_nope @ wk_up`` scores against the latent rows,
    plus ``q_rope . k_rope``; rows past each slot's position masked; the
    softmax-weighted latent, then ``@ wv_up``.  q_nope (B, 1, H, nd),
    q_rope (B, 1, H, rd), latent (B, Smax, r), k_rope (B, Smax, rd);
    ``pos0`` an int or a (B,) tensor.  Returns (B, 1, H, vd) f32."""
    lat = latent.float()
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(), wk_up.float())
    sc = torch.einsum("bshr,bjr->bshj", q_lat, lat)
    sc = sc + torch.einsum("bshk,bjk->bshj", q_rope.float(), k_rope.float())
    sc = sc * scale
    rows = torch.arange(latent.shape[1], device=latent.device)
    if torch.is_tensor(pos0):
        mask = (rows[None, :] <= pos0.reshape(-1, 1))[:, None, None, :]
    else:
        mask = rows <= int(pos0)
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o_lat = torch.einsum("bshj,bjr->bshr", p, lat)
    return torch.einsum("bshr,rhk->bshk", o_lat, wv_up.float())


def apply_mla(cfg: ModelConfig, params: Params, x: torch.Tensor, *, pos0,
              cache=None, tp_axis=None):
    """MLA: keys and values compressed into a per-token latent (plus one
    rotary key head shared by all heads).  A prompt (S > 1) materializes
    K and V from the latent and runs the flash kernel, causal, at (nd +
    rd, vd); one token (S == 1) with a cache runs the absorbed decode over
    the latent cache.

    pos0: absolute position of x[:, 0]; an int, or for ragged decode a
    (B,) tensor of per-slot positions.  cache: None or dict(latent (B,
    Smax, r), k_rope (B, Smax, rd)), written in place: decode writes each
    slot's row at its own position; a prompt writes rows [0, S), as the
    reference does whatever ``pos0`` is.  Returns (y, cache, aux)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = params["wq_up"].shape[1]
    nd, rd, r = m.nope_head_dim, m.rope_head_dim, m.kv_lora_rank
    ql = rms_norm({"scale": params["q_norm"]},
                  torch.matmul(x, params["wq_down"]), cfg.rms_eps)
    q = torch.einsum("bsr,rhk->bshk", ql, params["wq_up"])
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    kv = torch.matmul(x, params["wkv_down"])
    latent = rms_norm({"scale": params["kv_norm"]}, kv[..., :r], cfg.rms_eps)
    pos = positions(pos0, S, x.device)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], pos,
                        cfg.rope_theta)[:, :, 0, :]     # (B, S, rd)
    if cache is not None:
        lat_c, kr_c = cache["latent"], cache["k_rope"]
        if S == 1 and torch.is_tensor(pos0) and pos0.ndim == 1:
            bi = torch.arange(B, device=x.device)
            p = pos0.long()
            lat_c[bi, p] = latent[:, 0].to(lat_c.dtype)
            kr_c[bi, p] = k_rope[:, 0].to(kr_c.dtype)
        else:
            p = int(pos0) if S == 1 else 0
            lat_c[:, p:p + S] = latent.to(lat_c.dtype)
            kr_c[:, p:p + S] = k_rope.to(kr_c.dtype)
    scale = 1.0 / math.sqrt(nd + rd)
    if S == 1 and cache is not None:
        out = mla_absorbed_decode(q_nope, q_rope, cache["latent"],
                                  cache["k_rope"], params["wk_up"],
                                  params["wv_up"], pos0, scale).to(x.dtype)
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", latent, params["wk_up"])
        v = torch.einsum("bsr,rhk->bshk", latent, params["wv_up"])
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q_full.contiguous(), k_full.contiguous(),
                              v.contiguous(), causal=True, q_offset=0,
                              scale=scale)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return (_maybe_psum(y, tp_axis), cache,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
              tp_axis=None):
    """Gated MLP: SwiGLU, or GeGLU (tanh gelu) where ``mlp_act`` is
    "geglu"; or, where the params hold ``w1/w2`` (whisper), the plain
    two-matrix MLP with tanh gelu (``jax.nn.gelu``'s default form)."""
    if "w1" in params:
        h = F.gelu(torch.matmul(x, params["w1"]), approximate="tanh")
        y = torch.matmul(h, params["w2"])
    else:
        g = torch.matmul(x, params["w_gate"])
        u = torch.matmul(x, params["w_up"])
        y = torch.matmul(_act(cfg, g) * u, params["w_down"])
    return (_maybe_psum(y, tp_axis), None,
            torch.zeros((), dtype=torch.float32, device=x.device))


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    return (F.gelu(g, approximate="tanh") if cfg.mlp_act == "geglu"
            else F.silu(g))


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def moe_spec(cfg: ModelConfig) -> dict:
    """Param tree of one MoE MLP as (shape, init) leaves, with the scales
    of ``repro.models.layers.init_moe``: a ``(d, E)`` router, experts
    stacked on a leading ``E`` axis, and the shared experts as one gated
    MLP of width ``n_shared * d_expert``."""
    mo = cfg.moe
    d, fe, E = cfg.d_model, mo.d_expert, mo.n_experts
    s = 1.0 / math.sqrt(d)
    sf = 1.0 / math.sqrt(fe) / math.sqrt(2 * cfg.n_layers)
    spec = {"router": ((d, E), s), "w_gate": ((E, d, fe), s),
            "w_up": ((E, d, fe), s), "w_down": ((E, fe, d), sf)}
    if mo.n_shared:
        fs = fe * mo.n_shared
        spec["shared"] = {"w_gate": ((d, fs), s), "w_up": ((d, fs), s),
                          "w_down": ((fs, d), sf)}
    return spec


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Rows each expert takes in a call of T tokens (the reference's
    formula, in the same float arithmetic)."""
    mo = cfg.moe
    return max(int(math.ceil(T * mo.top_k / mo.n_experts
                             * mo.capacity_factor)), 4)


def moe_route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Routing of ``xt`` (T, d): the renormalised top-k weights and expert
    ids (T, K), each assignment's queue position in its expert (T, K), the
    kept mask (position < cap), the capacity, and the Switch aux loss.  No
    host sync: every shape is known from T."""
    mo = cfg.moe
    T, E, K = xt.shape[0], mo.n_experts, mo.top_k
    logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat = topi.reshape(-1)                                   # (t, k) order
    onehot = F.one_hot(flat, E)                               # (T K, E)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])
    pos = pos.reshape(T, K)
    cap = moe_capacity(cfg, T)
    # load balancing (Switch): E * sum(mean prob * assignment share)
    ce = onehot.sum(0).float() / (T * K)
    aux = E * torch.sum(probs.mean(0) * ce)
    return topw, topi, pos, pos < cap, cap, aux


def apply_moe(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
              tp_axis=None):
    """Top-k MoE with capacity-bounded dispatch (GShard style).  Returns
    (y, None, aux).

    Expert parallelism: the experts' leading dim is this rank's E_loc of
    the E experts along ``tp_axis`` (rank r holds experts [r E_loc, (r + 1)
    E_loc)); the router and the activations are whole on every rank, each
    rank runs only the kept assignments of its own experts, and the output
    psum combines them (no all-to-all)."""
    mo = cfg.moe
    B, S, d = x.shape
    T, K = B * S, mo.top_k
    E_loc = params["w_gate"].shape[0]
    e0 = comm.axis_index(tp_axis) * E_loc if tp_axis else 0
    xt = x.reshape(T, d)
    topw, topi, pos, keep, cap, aux = moe_route(cfg, params["router"], xt)
    # each kept assignment of a local expert owns row (expert, position) of
    # the dispatch buffer; the others all point at one spare row past the
    # experts' rows, which no expert reads and which combines with weight 0
    li = topi - e0
    mine = keep & (li >= 0) & (li < E_loc)
    row = torch.where(mine, li * cap + pos,
                      torch.full_like(pos, E_loc * cap)).reshape(-1)
    xe = x.new_zeros((E_loc * cap + 1, d))
    xe[row] = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
    xe = xe[:E_loc * cap].reshape(E_loc, cap, d)
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    ye = torch.bmm(_act(cfg, g) * u, params["w_down"]).reshape(E_loc * cap, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    w = (topw * mine).to(x.dtype).reshape(T, K, 1)
    y = (ye[row].reshape(T, K, d) * w).sum(dim=1).reshape(B, S, d)
    if mo.n_shared:
        sh = params["shared"]
        g = torch.matmul(x, sh["w_gate"])
        u = torch.matmul(x, sh["w_up"])
        y = y + torch.matmul(_act(cfg, g) * u, sh["w_down"])
    if tp_axis:
        y = comm.psum(y, tp_axis)
        aux = comm.psum(aux, tp_axis) / comm.axis_size(tp_axis)
    return y, None, aux
