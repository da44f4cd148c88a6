"""Flash attention for prefill: causal, optional sliding window, GQA.

Ports ``repro/kernels/flash_attention.py`` (``flash_attention``, a Pallas TPU
kernel).  The CUDA kernel is in ``csrc/flash_attention.cu``; its header says
what bounds it on an H100 and how the design answers it.

The wrapper keeps the Pallas signature: q ``(B, Sq, H, hd)``, k/v ``(B, Skv,
Kh, hd/hdv)``, out ``(B, Sq, H, hdv)``.  ``q_offset`` is the absolute
position of q row 0 within the kv span; ``None`` means END-aligned,
``Skv - Sq``.  Keys at or past ``Skv`` are masked; ``window`` applies only
when ``causal``.  Unlike the Pallas kernel, the CUDA kernel takes
``q_offset``, ``Sq`` and ``Skv`` at run time.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (hd, hdv) pairs instantiated in the .cu: every shape a caller in the JAX
# package passes (hd 256 is gemma3's; (192, 128) is MLA prefill's)
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                  (256, 256))


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may attend to."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          q_offset=None):
    """Masked softmax with the score matrix materialized, in f32."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    qf = q.float().reshape(B, Sq, Kh, G, hd) * scale
    s = torch.einsum("bqhgk,bjhk->bhgqj", qf, k.float())
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqj,bjhk->bhgqk", p, v.float()) \
        / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hdv).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int | None = None):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Kh, hd/hdv). Returns (B, Sq, H, hdv).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash attention: q, k and v must share one "
                             "device and dtype")
        if not t.is_contiguous():
            raise ValueError("flash attention: inputs must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash attention: the kernel copies k and v rows in "
                         "16-byte pieces; both must start on a 16-byte "
                         "boundary")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if (hd, hdv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash attention kernel is built for (hd, hdv) in "
                         f"{HEAD_DIM_PAIRS}, got hd={hd}, hdv={hdv}")
    if H % Kh:
        raise ValueError(f"flash attention: H={H} not a multiple of Kh={Kh}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = (Skv - Sq) if q_offset is None else int(q_offset)
    out = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    lib = build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Kh, hd, hdv, q_offset, int(causal), int(window), scale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out
