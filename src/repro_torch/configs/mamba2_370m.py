"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].
Copied from ``repro/configs/mamba2_370m.py``.

Every layer is a Mamba2 mixer (``models/ssm.py``) and holds no ``attn``
or ``mlp`` leaves; its decode state is constant in the sequence length."""

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    vocab=50280,
    d_model=1024,
    n_layers=48,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    attn_type="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2,
    ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, conv_width=4, chunk=16),
)

SKIP_LONG = None  # runs: constant-size recurrent state
