"""The plain reference of both configurations: a pre-norm decoder with
GQA attention under rotary positions and a non-gated tanh-GELU MLP, in
plain PyTorch and float32 with TF32 off.  StarCoder2 and BERT-base-as-a-
causal-LM share this block; a configuration file gives the sizes.

Per layer: ``x += wo(attn(rms(x) ln1))``, ``x += mlp.wo(gelu(mlp.wi(
rms(x) ln2)))``; then ``rms(x) final_norm`` and the head.  RMSNorm scales
by ``1 + w``; the token embedding is multiplied by sqrt(D) rounded to the
model dtype, as the program defines its model; RoPE rotates the two
halves of each head (theta from the configuration); scores are scaled by
1/sqrt(head_dim), causal, softmax in f32.  Nothing of the program is
imported.

Weights come in per layer as a dict of f32 tensors (``wq``, ``wk``,
``wv``, ``wo``, ``wi``, ``wo2``, ``ln1``, ``ln2``) so that a caller can
run the model a layer at a time.  ``mm`` is the matrix product, which the
low-precision control replaces.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def embed_scale(cfg: dict) -> float:
    dt = getattr(torch, cfg["dtype"])
    return float(torch.tensor(math.sqrt(cfg["d_model"])).to(dt))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., S, H, hd], positions [S]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA: q [..., S, H, hd], k/v [..., S, KV, hd] -> [..., S,
    H * hd]; query head h reads key/value head h // (H // KV)."""
    S, H, hd = q.shape[-3:]
    G = H // k.shape[-2]
    k = k.repeat_interleave(G, dim=-2)
    v = v.repeat_interleave(G, dim=-2)
    s = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", p, v).flatten(-2)


def layer(cfg: dict, w: dict, x: torch.Tensor, mm=plain_mm) -> torch.Tensor:
    """One decoder layer over sequences x [..., S, D]."""
    S = x.shape[-2]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = rms(x, w["ln1"])
    q = rope(mm(h, w["wq"]).unflatten(-1, (H, hd)), pos, cfg["rope_theta"])
    k = rope(mm(h, w["wk"]).unflatten(-1, (KV, hd)), pos, cfg["rope_theta"])
    v = mm(h, w["wv"]).unflatten(-1, (KV, hd))
    x = x + mm(attention(q, k, v), w["wo"])
    h = rms(x, w["ln2"])
    return x + mm(F.gelu(mm(h, w["wi"]), approximate="tanh"), w["wo2"])


def embed(cfg: dict, table: torch.Tensor, tokens: torch.Tensor
          ) -> torch.Tensor:
    return table[tokens] * embed_scale(cfg)


def logits(x: torch.Tensor, final_norm: torch.Tensor, head: torch.Tensor,
           mm=plain_mm) -> torch.Tensor:
    return mm(rms(x, final_norm), head)
