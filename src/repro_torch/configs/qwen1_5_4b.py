"""qwen1.5-4b [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — gated SiLU MLP, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].
Copied from ``repro/configs/qwen1_5_4b.py``."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    vocab=151936,
    d_model=2560,
    n_layers=40,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    attn_type="gqa",
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
)
