"""Serving runtime of the PyTorch port: device resolution, health,
lifecycle and circuit breaking."""

from .backend import resolve_device

__all__ = ["resolve_device"]
