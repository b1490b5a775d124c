"""Deterministic synthetic data pipelines (numpy only)."""
from .synthetic import (SyntheticLM, SyntheticClassification,  # noqa: F401
                        Prefetcher, lm_batches, classification_batches)
