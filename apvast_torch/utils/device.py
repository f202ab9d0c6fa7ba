"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another. There is no silent CPU path: without a card this raises
    unless the caller passed ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apvast_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def torch_dtype(config) -> torch.dtype:
    """The torch dtype of ``config.dtype`` ('float32' or 'float64')."""
    return {"float32": torch.float32, "float64": torch.float64}[config.dtype]
