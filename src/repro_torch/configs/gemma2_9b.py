"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118].
Copied from ``repro/configs/gemma2_9b.py``.

Local layers keep a ring cache of ``local_window`` rows; global layers
hold the full cache."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    vocab=256000,
    d_model=3584,
    n_layers=42,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    attn_type="gqa",
    layer_pattern="alt_local_global",
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, local_window=16,
)
