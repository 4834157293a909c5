"""Device resolution for the PyTorch port.

Every entry point that owns device state (``FlatTreeScorer``,
``load_artifact``, ``start_server``) takes ``device=None``, which means
the CUDA card. Without a card that is an error, never a silent move to
the CPU: a caller who wants the CPU (the parity tests do) says
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one);
    ``"cpu"``/``"cuda"``/``"cuda:N"``/``torch.device`` -> that device,
    checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to "
                "run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no "
                               "CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
