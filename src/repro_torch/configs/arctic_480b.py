"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].
Copied from ``repro/configs/arctic_480b.py``.

The port runs it at SMOKE only: its ~470 B expert parameters need more
than one card (full width waits for distribution)."""

from repro_torch.models.common import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    vocab=32000,
    d_model=7168,
    n_layers=35,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    attn_type="gqa",
    moe=MoEConfig(num_experts=128, top_k=2, d_expert=4864,
                  capacity_factor=1.25, dense_residual=True,
                  dense_residual_ff=4864),
    act="silu",
    gated_mlp=True,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, dense_residual=True,
                  dense_residual_ff=64),
)
