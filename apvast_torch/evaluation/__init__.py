"""Evaluation metrics of the port (contrast, NMSE, predicted pressure)."""

from apvast_torch.evaluation.metrics import (
    acoustic_contrast_db,
    normalized_mse,
    predict_pressure,
)

__all__ = ["acoustic_contrast_db", "normalized_mse", "predict_pressure"]
