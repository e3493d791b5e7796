"""BERT_BASE-scale config for the paper's own evaluation (Figs 8-11):
12L d_model=768 12H d_ff=3072 — the model STen sparsifies with n:m:g.
Copied from ``repro/configs/bert_base_sten.py``; the benchmark uses it as a
causal LM backbone."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="bert-base-sten",
    vocab=30522,
    d_model=768,
    n_layers=12,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    attn_type="gqa",
    act="gelu",
    gated_mlp=False,
)

SMOKE = CONFIG.scaled(vocab=512, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, head_dim=16, d_ff=128)
