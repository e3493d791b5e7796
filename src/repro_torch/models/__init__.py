"""The ported model stack (GQA dense decoder, plain or gated MLP) and its
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
