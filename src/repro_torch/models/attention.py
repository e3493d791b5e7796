"""Attention for the ported decoder: RoPE, causal / sliding-window /
prefix-LM attention for prefill, single-token decode attention, GQA and
MLA (multi-head latent attention, minicpm3) with its absorbed decode over
the compressed cache (port of ``repro/models/attention.py``).

Attention was never a Pallas kernel in the reference, so this is plain
PyTorch.  ``chunked_attention`` keeps the reference's interface and f32
compute; it takes an exact softmax over all keys for each query chunk
instead of the reference's online softmax over key chunks, which differs
from it only by summation order.  MLA's dense projections are plain
products (``mm``; only ``wo`` is converted for serving), and its latent
einsums run in f32, as the reference computes them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import ModelConfig, mm, mm_fused_qkv, \
    torch_dtype

__all__ = ["pos_vec", "rope", "chunked_attention", "decode_attention",
           "init_gqa", "apply_gqa", "init_mla", "apply_mla", "decode_mla"]

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
    """q, k [B, Sq|Sk, H|KV, hd]; v [B, Sk, KV, hdv] (H % KV == 0; the
    value width may differ from the q/k width, as MLA's does); head h
    reads kv head h // (H // KV); scores scale by 1/sqrt(hd).
    ``window``: key positions more than ``window - 1`` before the query
    are masked; ``prefix_len`` P: the first P keys are visible to every
    query (the prefix-LM mask, bidirectional over the prefix);
    ``softcap`` c maps each score s to c·tanh(s/c) before the mask.
    Returns [B, Sq, H, hdv] in q.dtype."""
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
                     softcap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode: q [B, 1, H, hd]; caches [B, S, KV, hd];
    ``cache_len`` [] or [B] valid length(s), the new token included;
    ``softcap`` as in :func:`chunked_attention`.  ``window``: only the
    last ``window`` valid rows are attended (a local layer over a
    full-length cache); a ring's window is its length
    (``models/transformer.py:init_cache``)."""
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
    if window is not None:
        valid &= pos[None, None, None, :] > (cl - 1 - window)
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
              prefix_len: int = 0, positions=None, causal: bool = True):
    """Self-attention over x [B, S, D]: causal (``causal``), over
    ``cfg.local_window`` keys in a local layer, and bidirectional over the
    first ``prefix_len`` positions (a VLM prefix); returns (y, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal,
                            window=cfg.local_window if is_local else None,
                            prefix_len=prefix_len,
                            softcap=cfg.attn_softcap,
                            chunk_q=cfg.attn_chunk_q,
                            compute_dtype=torch_dtype(cfg.attn_dtype))
    return mm(out.reshape(B, S, -1), p["wo"]), (k, v)


def init_mla(gen: torch.Generator, cfg: ModelConfig, *, L: int, device):
    """Stacked [L, ...] MLA projections in the reference's leaves (the
    down/up projections of q and of the joint KV latent, the decoupled
    RoPE key ``wkr``, ``wo``; truncated-normal fan-in init) and its two
    latent norms, ones."""
    from repro_torch.models.transformer import dense_init

    mla = cfg.mla
    D, H, dt = cfg.d_model, cfg.n_heads, cfg.tdtype
    qk_hd = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    r = mla.kv_lora_rank
    return {
        "wdq": dense_init(gen, (L, D, mla.q_lora_rank), dt, device),
        "wuq": dense_init(gen, (L, mla.q_lora_rank, H * qk_hd), dt, device),
        "wdkv": dense_init(gen, (L, D, r), dt, device),
        "wuk": dense_init(gen, (L, r, H * mla.qk_nope_head_dim), dt, device),
        "wuv": dense_init(gen, (L, r, H * mla.v_head_dim), dt, device),
        "wkr": dense_init(gen, (L, D, mla.qk_rope_head_dim), dt, device),
        "wo": dense_init(gen, (L, H * mla.v_head_dim, D), dt, device),
        "q_norm": torch.ones(L, mla.q_lora_rank, dtype=dt, device=device),
        "kv_norm": torch.ones(L, r, dtype=dt, device=device),
    }


def _mla_rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """MLA's latent RMSNorm, the reference's own: normalised in f32,
    rounded to x.dtype, then scaled by ``w`` itself (not the
    transformer's ``1 + w`` in f32)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope [B, S, H, nd], q_rope [B, S, H, rd]) with RoPE applied."""
    mla = cfg.mla
    B, S, _ = x.shape
    nd, rd = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    cq = _mla_rms(mm(x, p["wdq"]), p["q_norm"])
    q = mm(cq, p["wuq"]).reshape(B, S, cfg.n_heads, nd + rd)
    return q[..., :nd], rope(q[..., nd:], positions, cfg.rope_theta)


def _mla_kv_latent(p, x, cfg: ModelConfig, positions):
    """The compressed cache entries of x: (ckv [B, S, r], k_rope
    [B, S, 1, rd] with RoPE applied)."""
    B, S, _ = x.shape
    ckv = _mla_rms(mm(x, p["wdkv"]), p["kv_norm"])
    k_rope = rope(mm(x, p["wkr"]).reshape(B, S, 1, cfg.mla.qk_rope_head_dim),
                  positions, cfg.rope_theta)
    return ckv, k_rope


def apply_mla(p, x, cfg: ModelConfig, *, positions=None,
              causal: bool = True):
    """MLA over x [B, S, D], un-absorbed: keys and values re-expanded from
    the latent per head, q/k head width nd + rd (scale 1/sqrt(nd + rd)),
    value width vd.  Returns (y, ckv [B, S, r], k_rope [B, S, 1, rd]),
    the latter two what decode caches.  As in the reference, no prefix
    mask reaches MLA."""
    mla = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, k_rope = _mla_kv_latent(p, x, cfg, positions)
    k_nope = mm(ckv, p["wuk"]).reshape(B, S, H, nd)
    v = mm(ckv, p["wuv"]).reshape(B, S, H, vd)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(q, k, v, causal=causal, chunk_q=cfg.attn_chunk_q,
                            compute_dtype=torch_dtype(cfg.attn_dtype))
    return mm(out.reshape(B, S, -1), p["wo"]), ckv, k_rope


def decode_mla(p, x, cfg: ModelConfig, ckv_c, kr_c, pv, *, q_cache,
               dq_cache):
    """Absorbed MLA decode of one layer over the compressed cache views
    ``ckv_c`` [B, S, r] and ``kr_c`` [B, S, rd]: writes this token's
    latent and RoPE key at row ``pv`` in place, then scores in latent
    space (q_nope absorbed through ``wuk``, so attention reads the latent
    directly) and re-expands the output through ``wuv``, in f32.  ``x``
    [B, 1, D], ``pv`` [B] positions.  ``q_cache(t, cfg)`` stores a tile
    in the cache's dtype (int8 codes for an int8 cache) and ``dq_cache(t,
    cfg)`` reads a view back in the model dtype (the reference's hooks,
    ``models/transformer.py:_q_cache`` / ``_dq_cache``).  A write past
    the cache end is clamped onto its last row where the reference drops
    it (ROADMAP C2): only a finished slot writes there.  ``wuk`` and
    ``wuv`` are reshaped per head, so they stay dense tensors."""
    mla = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    nd, rd, vd = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    positions = pv[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv_t, kr_t = _mla_kv_latent(p, x, cfg, positions)
    rows = torch.arange(B, device=x.device)
    S = ckv_c.shape[1]
    wpos = pv.clamp(max=S - 1).long()
    ckv_c.index_put_((rows, wpos), q_cache(ckv_t[:, 0], cfg))
    kr_c.index_put_((rows, wpos), q_cache(kr_t.reshape(B, rd), cfg))
    ckv = dq_cache(ckv_c, cfg).float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(),
                         p["wuk"].reshape(r, H, nd).float())
    s = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                         dq_cache(kr_c, cfg).float())
    s = s * (1.0 / math.sqrt(nd + rd))
    valid = torch.arange(S, device=x.device)[None, None, :] \
        < (pv + 1)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    out_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), ckv)
    out = torch.einsum("bhr,rhv->bhv", out_lat,
                       p["wuv"].reshape(r, H, vd).float())
    return mm(out.reshape(B, 1, H * vd).to(x.dtype), p["wo"])
