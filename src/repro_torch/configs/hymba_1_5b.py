"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].
Copied from ``repro/configs/hymba_1_5b.py``.

Every layer runs sliding-window attention and a Mamba2 mixer side by side
on the same normed input and averages them; every layer is local, over a
full-length cache (a ring only when the cache is no longer than the
window)."""

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    vocab=32001,
    d_model=1600,
    n_layers=32,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    attn_type="hybrid",
    layer_pattern="local",
    local_window=2048,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    act="silu",
    gated_mlp=True,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, local_window=16,
    ssm=SSMConfig(state_dim=8, head_dim=8, expand=2, conv_width=4, chunk=16),
)
