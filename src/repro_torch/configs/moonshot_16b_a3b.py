"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf].
Copied from ``repro/configs/moonshot_16b_a3b.py``.

Every layer's FFN is the capacity-dispatched MoE (``models/moe.py``);
the layers hold no ``mlp`` leaves."""

from repro_torch.models.common import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    vocab=163840,
    d_model=2048,
    n_layers=48,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    attn_type="gqa",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  capacity_factor=1.25),
    act="silu",
    gated_mlp=True,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
)

SKIP_LONG = "pure full attention (quadratic 524288 prefill / full cache)"
