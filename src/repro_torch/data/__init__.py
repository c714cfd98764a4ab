"""Data pipeline with progress-engine prefetch."""
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
