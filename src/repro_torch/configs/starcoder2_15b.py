"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].
Copied from ``repro/configs/starcoder2_15b.py``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    vocab=49152,
    d_model=6144,
    n_layers=40,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    attn_type="gqa",
    act="gelu",
    gated_mlp=False,
    rope_theta=100_000.0,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
)
