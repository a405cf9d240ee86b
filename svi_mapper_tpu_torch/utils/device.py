"""The device rule of the port: ``None`` means CUDA, and nothing carries on
on the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); anything else is
    taken as given. Callers that want the CPU say ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "svi_mapper_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
