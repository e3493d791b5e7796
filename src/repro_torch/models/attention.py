"""Attention for the ported GQA decoder: RoPE, causal attention for
prefill, single-token decode attention (port of the GQA part of
``repro/models/attention.py``).

Attention was never a Pallas kernel in the reference, so this is plain
PyTorch.  ``chunked_attention`` keeps the reference's interface and f32
compute; it takes an exact softmax over all keys for each query chunk
instead of the reference's online softmax over key chunks, which differs
from it only by summation order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import ModelConfig, mm, mm_fused_qkv, \
    torch_dtype

__all__ = ["pos_vec", "rope", "chunked_attention", "decode_attention",
           "init_gqa", "apply_gqa"]

NEG_INF = -1e30


def pos_vec(pos, B: int, device=None) -> torch.Tensor:
    """A decode position as a per-batch [B] int32 vector (a scalar
    broadcasts to every row)."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if p.ndim == 0:
        p = p.reshape(1).expand(B)
    return p


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [B, S, H, hd] (hd even); positions [B, S] or [S].  Computes in
    f32 and casts back to x.dtype, as the reference does."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs      # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _block_mask(qpos, kpos, *, causal: bool, window: Optional[int],
                prefix_len: int) -> torch.Tensor:
    """qpos [cq], kpos [ck] -> bool [cq, ck] (True = visible)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > (qpos[:, None] - window)
    if prefix_len:
        m |= kpos[None, :] < prefix_len
    return m


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, prefix_len: int = 0,
                      softcap: Optional[float] = None, chunk_q: int = 512,
                      q_offset: int = 0,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, KV, hd] (H % KV == 0); head h reads
    kv head h // (H // KV).  ``window``: key positions more than
    ``window - 1`` before the query are masked; ``softcap`` c maps each
    score s to c·tanh(s/c) before the mask.  Returns [B, Sq, H, hd] in
    q.dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    cdt = compute_dtype
    kf = k.to(cdt).repeat_interleave(G, dim=2)           # [B, Sk, H, hd]
    vf = v.to(cdt).repeat_interleave(G, dim=2)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, chunk_q):
        qc = q[:, q0:q0 + chunk_q].to(cdt)
        qpos = q_offset + q0 + torch.arange(qc.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf).float() * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _block_mask(qpos, kpos, causal=causal, window=window,
                           prefix_len=prefix_len)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(cdt), vf).float())
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q [B, 1, H, hd]; caches [B, S, KV, hd];
    ``cache_len`` [] or [B] valid length(s), the new token included;
    ``softcap`` as in :func:`chunked_attention`.  A local layer's window
    is its ring's length (``models/transformer.py:init_cache``)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.ndim == 1:
        cl = cl[:, None, None, None]
    valid = pos[None, None, None, :] < cl
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def init_gqa(gen: torch.Generator, cfg: ModelConfig, *, L: int, device):
    """Stacked [L, ...] GQA projections, truncated-normal fan-in init;
    with ``cfg.qkv_bias`` also zero biases ``bq``/``bk``/``bv``."""
    from repro_torch.models.transformer import dense_init

    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (L, D, H * hd), cfg.tdtype, device),
        "wk": dense_init(gen, (L, D, KV * hd), cfg.tdtype, device),
        "wv": dense_init(gen, (L, D, KV * hd), cfg.tdtype, device),
        "wo": dense_init(gen, (L, H * hd, D), cfg.tdtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(L, width, dtype=cfg.tdtype, device=device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = mm_fused_qkv(x, p["wq"], p["wk"], p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def apply_gqa(p, x, cfg: ModelConfig, *, is_local: bool = False,
              positions=None):
    """Causal self-attention over x [B, S, D], over ``cfg.local_window``
    keys in a local layer; returns (y, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=True,
                            window=cfg.local_window if is_local else None,
                            softcap=cfg.attn_softcap,
                            chunk_q=cfg.attn_chunk_q,
                            compute_dtype=torch_dtype(cfg.attn_dtype))
    return mm(out.reshape(B, S, -1), p["wo"]), (k, v)
