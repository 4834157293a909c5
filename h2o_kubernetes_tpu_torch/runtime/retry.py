"""Environment-knob parsing shared by the serving runtime."""

from __future__ import annotations

import logging
import os

__all__ = ["_env_float"]


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logging.getLogger("h2o_kubernetes_tpu_torch").warning(
            "ignoring unparseable %s=%r", name, raw)
        return default
