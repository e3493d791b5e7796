"""The ported model stack (a decoder with GQA or MLA attention, a Mamba2
SSD mixer or both, a plain or gated MLP or a mixture of experts, an
optional VLM prefix, an optional encoder with cross-attention) and its
training loss."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_lm,
    logits_of,
    loss_fn,
    prefill,
    prefill_into_slot,
)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache", "init_lm",
           "logits_of", "loss_fn", "prefill", "prefill_into_slot"]
