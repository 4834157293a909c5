"""Configuration: two tiers for ``log_level`` and ``nbins``, and the
environment knobs read by the port.

``get_config(key)`` / ``set_config(key, value)`` are the JAX package's
programmatic tier (``h2o.set_config``): a value set there wins over the
environment (``H2O_TPU_LOG_LEVEL``, ``H2O_TPU_NBINS``), which wins over
the default; both tiers share one validation (``_validate``), and a bad
value is refused before it is stored. The environment tier is read at
USE time, like every other knob here, so a live server can be re-tuned
without a restart. Names and defaults are the JAX package's, so one
deployment manifest configures either package. The JAX package's third
key, ``hist_impl`` (Pallas or segment-sum histograms), is not ported:
the port's histogram build dispatches on the tensor's device
(ops/histogram.py) and has no switch.

| env var | default | meaning |
|---|---|---|
| H2O_TPU_LOG_LEVEL | WARNING | level of the ``h2o_kubernetes_tpu_torch`` logger (``diagnostics.log``) |
| H2O_TPU_NBINS | 256 | default histogram bins per feature (incl. the NA bin) for the tree learners, in [4, 256] (models/gbm.py) |
| H2O_TPU_HIST_BYTES_BUDGET | 2³⁰ | deep-tree level-histogram memory budget: a GBM whose deepest level's histograms need more raises up front (models/gbm.py) |
| H2O_TPU_EFB | auto | Exclusive Feature Bundling: 0 off, 1 plan at any width and keep any shrink, auto plan frames of >= H2O_TPU_EFB_MIN_F features and keep a plan whose bundled width Fb <= H2O_TPU_EFB_MIN_SHRINK · F (models/tree/efb.py) |
| H2O_TPU_EFB_CONFLICT | 0 | fraction of rows two members of one bundle may both claim (first member wins); 0 = exact exclusivity; a member past it on the full data is demoted to its own column (models/tree/efb.py) |
| H2O_TPU_EFB_MIN_F | 64 | auto mode's width floor: narrower frames are never planned (models/tree/efb.py) |
| H2O_TPU_EFB_MIN_SHRINK | 0.75 | auto mode keeps a plan only when Fb <= this · F (models/tree/efb.py) |
| H2O_TPU_ARROW_CSV | 1 | 0 keeps every CSV import on the pure-Python reader; otherwise pyarrow's streamed reader takes the files it parses as that reader would (main thread only, pyarrow importable, single-character separator, no xz; frame/parse.py `_arrow_csv_eligible`) |
| H2O_TPU_INGEST_CHUNK_BYTES | 16 MiB | bytes per record batch of the pyarrow CSV reader; a value that is not an int reads as the default (frame/parse.py) |
| H2O_TPU_SVMLIGHT_DENSE_BUDGET | 200,000,000 | most cells (rows x max feature index) an SVMLight import may densify to; past it the import raises (frame/parse.py) |
| H2O_TPU_GOSS | 0 | 1 = gradient-based one-side sampling for boosted trees (GBM, pointwise XGBoost): per round the top-a rows by |g| plus a seeded b of the rest, amplified by (1-a)/b; DRF and rank:* never sample (models/gbm.py `goss_params`) |
| H2O_TPU_GOSS_TOP_A | 0.1 | GOSS's a, in [0, 1) (models/gbm.py) |
| H2O_TPU_GOSS_RAND_B | 0.1 | GOSS's b, in (0, 1], a + b <= 1 (models/gbm.py) |
| H2O_TPU_OOC | auto | out-of-core boosting: 1 force (where eligible), 0 off, auto when the uint8 binned matrix passes the headroom H2O_TPU_HIST_BYTES_BUDGET leaves after the level histograms; multinomial, DRF, huber, checkpoints, score_every, row/column sampling and mtries stay in device memory (models/gbm.py `_ooc_chunk_rows`) |
| H2O_TPU_OOC_CHUNK_ROWS | unset | rows per streamed chunk; unset: a quarter of the budget's headroom over F, at least 1 MiB of codes (models/tree/ooc.py `chunk_rows_for`) |
| H2O_TPU_OOC_RESIDENT | 0 | 1 keeps the out-of-core chunks on the device instead of streaming them from pinned host memory (the streamed = resident check; models/tree/ooc.py) |
| H2O_TPU_SCORE_BATCH_US | 2000 | REST scoring micro-batcher window, µs; 0 = dispatch immediately (rest.py) |
| H2O_TPU_SCORE_TIMEOUT | 60 | seconds a scoring request may wait for its micro-batched result before 503 (rest.py) |
| H2O_TPU_SCORE_QUEUE_MAX | 256 | scoring admission-queue bound: requests past it are load-shed with 429 + Retry-After; <=0 unbounded (rest.py) |
| H2O_TPU_SCORE_MAX_ROWS | 100000 | per-request row cap on the inline scoring route (413 past it) |
| H2O_TPU_CONTRIB_MAX_ROWS | 100000 | per-request row cap on the TreeSHAP contributions route (413 past it; rest.py) |
| H2O_TPU_CONTRIB_CHUNK | unset (16384 where chunked) | cap on rows per TreeSHAP dispatch, pow2-floored. On a CUDA device whose depth groups all have pattern tables the kernel takes the whole batch, unpadded, and the knob caps it only when set; on the CPU and where a group takes the DP path, the JAX rule: chunks of the cap (16384 when unset) shrunk until rows × leaves × depth ≤ 2²⁴, each padded to its pow2 bucket (models/base.py `contrib_dispatch`) |
| H2O_TPU_POOL_WARM_BUCKETS | 128,1024 | default warm-up ladder: Model.warm_up runs every pow2 batch bucket up to the largest listed before a replica's readyz flips (models/base.py) |
| H2O_TPU_BREAKER_FAILURES | 5 | consecutive device-dispatch errors that trip the serving circuit breaker open (runtime/lifecycle.py) |
| H2O_TPU_BREAKER_COOLDOWN | 30 | seconds the breaker stays open before admitting the half-open probe (runtime/lifecycle.py) |
| H2O_TPU_DRAIN_TIMEOUT | 30 | seconds the drain waits for the batcher flush (runtime/lifecycle.py) |
"""

from __future__ import annotations

import logging
import os
from typing import Any

__all__ = ["get_config", "set_config", "CONFIG", "default_nbins",
           "hist_bytes_budget", "arrow_csv_enabled", "ingest_chunk_bytes",
           "svmlight_dense_budget"]

_DEFAULTS: dict[str, Any] = {"log_level": "WARNING", "nbins": 256}

_ENV_KEYS = {"log_level": "H2O_TPU_LOG_LEVEL", "nbins": "H2O_TPU_NBINS"}

# the programmatic tier: the values set_config stored
CONFIG: dict[str, Any] = {}


def _validate(key: str, value: Any) -> Any:
    """One rule set for both tiers; returns the coerced value or raises
    ValueError."""
    if key == "nbins":
        value = int(value)
        if not 4 <= value <= 256:
            raise ValueError("nbins must be in [4, 256]")
    if key == "log_level" and not isinstance(
            getattr(logging, str(value).upper(), None), int):
        raise ValueError(f"unknown log level '{value}'")
    return value


def _known(key: str) -> None:
    if key not in _DEFAULTS:
        raise KeyError(f"unknown config key '{key}' "
                       f"(known: {sorted(_DEFAULTS)})")


def get_config(key: str) -> Any:
    """The value set by ``set_config``, else the validated environment
    value, else the default."""
    _known(key)
    if key in CONFIG:
        return CONFIG[key]
    raw = os.environ.get(_ENV_KEYS[key])
    if raw is None:
        return _DEFAULTS[key]
    try:
        return _validate(key, raw)
    except (ValueError, TypeError) as e:
        raise ValueError(f"bad {_ENV_KEYS[key]}={raw!r}: {e}") from None


def set_config(key: str, value: Any) -> None:
    """Programmatic tier: applies at once (and re-levels the package
    logger for ``log_level``); a bad value raises before it is stored."""
    _known(key)
    value = _validate(key, value)
    CONFIG[key] = value
    if key == "log_level":
        from .diagnostics import log

        log.setLevel(getattr(logging, str(value).upper()))


def default_nbins() -> int:
    """Default histogram bins per feature, in [4, 256]: ``nbins``."""
    return get_config("nbins")


def hist_bytes_budget() -> float:
    """H2O_TPU_HIST_BYTES_BUDGET (default 2**30 bytes)."""
    return float(os.environ.get("H2O_TPU_HIST_BYTES_BUDGET", 2 ** 30))


def arrow_csv_enabled() -> bool:
    """H2O_TPU_ARROW_CSV (default 1): 0 disables the pyarrow CSV path."""
    return os.environ.get("H2O_TPU_ARROW_CSV", "1") != "0"


def ingest_chunk_bytes() -> int:
    """H2O_TPU_INGEST_CHUNK_BYTES (default 16 MiB). A typo must not
    demote every ingest to the pure-Python reader (the caller would
    read a ValueError as arrow rejecting the file), so a value that is
    not an int reads as the default."""
    try:
        return int(os.environ.get("H2O_TPU_INGEST_CHUNK_BYTES", 16 << 20))
    except ValueError:
        return 16 << 20


def svmlight_dense_budget() -> int:
    """H2O_TPU_SVMLIGHT_DENSE_BUDGET (default 200,000,000 cells)."""
    return int(os.environ.get("H2O_TPU_SVMLIGHT_DENSE_BUDGET",
                              200_000_000))
