"""Architecture registry: the 10 assigned archs x 4 input shapes (40
cells), plus the paper's own BERT_BASE-scale evaluation config (port of
``repro/configs/registry.py``).

``input_specs`` returns tensors on the ``meta`` device for every model
input of an (arch, shape) cell, the counterpart of the reference's
``jax.ShapeDtypeStruct`` stand-ins: shapes and dtypes, no storage, which
is what the dry-run (``launch/dryrun.py``) traces against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import (
    arctic_480b,
    bert_base_sten,
    gemma2_9b,
    hymba_1_5b,
    mamba2_370m,
    minicpm3_4b,
    moonshot_16b_a3b,
    paligemma_3b,
    qwen1_5_4b,
    starcoder2_15b,
    whisper_large_v3,
)
from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_arch", "get_smoke",
           "input_specs", "runnable_cells", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | decode (long)


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# the reference's order, which is the grid's
_MODULES = {
    "qwen1.5-4b": qwen1_5_4b,
    "starcoder2-15b": starcoder2_15b,
    "gemma2-9b": gemma2_9b,
    "minicpm3-4b": minicpm3_4b,
    "paligemma-3b": paligemma_3b,
    "moonshot-v1-16b-a3b": moonshot_16b_a3b,
    "arctic-480b": arctic_480b,
    "mamba2-370m": mamba2_370m,
    "whisper-large-v3": whisper_large_v3,
    "hymba-1.5b": hymba_1_5b,
    "bert-base-sten": bert_base_sten,
}

ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}


def get_arch(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


def skip_reason(name: str, shape: str) -> Optional[str]:
    mod = _MODULES[name]
    if shape == "long_500k" and mod.SKIP_LONG:
        return mod.SKIP_LONG
    return None


def runnable_cells(include_paper_model: bool = False):
    """The (arch, shape) grid with skip annotations."""
    cells = []
    for name in _MODULES:
        if name == "bert-base-sten" and not include_paper_model:
            continue
        for shape in SHAPES:
            cells.append((name, shape, skip_reason(name, shape)))
    return cells


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override: Optional[int] = None) -> dict:
    """Meta-tensor inputs for the cell's step function.

    train:   {'tokens', 'labels'} [B, S] int32 (+ modality stubs)
    prefill: {'tokens'} [B, S] (+ modality stubs)
    decode:  {'token' [B, 1]}: the KV cache is ``init_cache(...,
             device="meta")`` (see launch/dryrun.py).
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _spec((B, S), torch.int32)
        specs["labels"] = _spec((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _spec((B, S), torch.int32)
    else:  # decode
        specs["token"] = _spec((B, 1), torch.int32)

    # modality stubs (the frontend provides precomputed embeddings)
    if cfg.vision_prefix and shape.kind in ("train", "prefill"):
        specs["prefix_embeds"] = _spec((B, cfg.vision_prefix, cfg.d_model),
                                       cfg.tdtype)
    if cfg.n_enc_layers > 0 and shape.kind in ("train", "prefill"):
        # whisper: encoder frames, bounded by the 30 s receptive field
        enc_len = min(S, whisper_large_v3.ENC_LEN) if \
            cfg.name.startswith("whisper") else S
        specs["enc_embeds"] = _spec((B, enc_len, cfg.d_model), cfg.tdtype)
    return specs
