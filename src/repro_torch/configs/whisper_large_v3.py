"""whisper-large-v3 [audio]: 32L (+32L enc) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — enc-dec, conv frontend stub [arXiv:2212.04356].
Copied from ``repro/configs/whisper_large_v3.py``.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, enc_len, d_model].  RoPE replaces the
original sinusoidal/learned positions, RMSNorm the LayerNorms, and the
projections have no biases, as in the reference's backbone."""

from repro_torch.models.common import ModelConfig

ENC_LEN = 1500  # 30 s of audio at 50 Hz after the conv frontend

CONFIG = ModelConfig(
    name="whisper-large-v3",
    vocab=51866,
    d_model=1280,
    n_layers=32,
    n_enc_layers=32,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    attn_type="gqa",
    act="gelu",
    gated_mlp=False,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_enc_layers=2, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128,
)

FAMILY = "audio"
