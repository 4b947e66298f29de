"""The deterministic synthetic data pipeline."""
from .pipeline import BatchSpec, DataConfig, SyntheticLMDataset, make_batch_specs

__all__ = ["BatchSpec", "DataConfig", "SyntheticLMDataset",
           "make_batch_specs"]
