"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention) [hf:openbmb/MiniCPM3-4B; hf].
Copied from ``repro/configs/minicpm3_4b.py``.

Decode runs the absorbed-latent attention over the compressed cache
``{"ckv" [B, S, kv_lora_rank], "kr" [B, S, qk_rope_head_dim]}``."""

from repro_torch.models.common import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    vocab=73448,
    d_model=2560,
    n_layers=62,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    attn_type="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    act="silu",
    gated_mlp=True,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
)

SKIP_LONG = "pure full attention (quadratic 524288 prefill / full cache)"
