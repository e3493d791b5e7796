"""Architecture registry of the port: the architectures it runs so far."""

from repro_torch.configs import arctic_480b, bert_base_sten, gemma2_9b, \
    hymba_1_5b, mamba2_370m, minicpm3_4b, moonshot_16b_a3b, paligemma_3b, \
    qwen1_5_4b, starcoder2_15b, whisper_large_v3
from repro_torch.models.common import ModelConfig

__all__ = ["get_config", "get_smoke"]

_MODULES = {"bert-base-sten": bert_base_sten, "qwen1.5-4b": qwen1_5_4b,
            "starcoder2-15b": starcoder2_15b, "gemma2-9b": gemma2_9b,
            "paligemma-3b": paligemma_3b, "minicpm3-4b": minicpm3_4b,
            "moonshot-v1-16b-a3b": moonshot_16b_a3b,
            "arctic-480b": arctic_480b, "mamba2-370m": mamba2_370m,
            "hymba-1.5b": hymba_1_5b, "whisper-large-v3": whisper_large_v3}


def _module(name: str):
    if name not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet "
            f"(ported: {', '.join(_MODULES)})")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
