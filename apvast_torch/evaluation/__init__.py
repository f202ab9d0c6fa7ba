"""Evaluation metrics of the port (contrast, NMSE, predicted pressure,
detectability)."""

from apvast_torch.evaluation.metrics import (
    acoustic_contrast_db,
    detectability,
    normalized_mse,
    predict_pressure,
)

__all__ = ["acoustic_contrast_db", "detectability", "normalized_mse", "predict_pressure"]
