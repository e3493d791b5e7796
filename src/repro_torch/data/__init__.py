"""Synthetic, index-addressed LM batches (port of ``repro/data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

__all__ = ["DataConfig", "SyntheticLMPipeline"]
