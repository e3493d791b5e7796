"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma [arXiv:2407.07726; hf].
Copied from ``repro/configs/paligemma_3b.py``.

The vision frontend is a stub, as in the reference: the caller passes
``vision_prefix`` precomputed patch embeddings [B, 256, d_model]
(``prefix_embeds=``), and the backbone attends bidirectionally over them
(a prefix-LM mask) and causally over the text."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    vocab=257216,
    d_model=2048,
    n_layers=18,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    attn_type="gqa",
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    vision_prefix=256,
)

SMOKE = CONFIG.scaled(
    vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vision_prefix=8,
)

SKIP_LONG = "pure full attention (quadratic 524288 prefill / full cache)"
