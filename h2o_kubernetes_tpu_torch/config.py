"""Environment knobs read by the port.

Each knob is read at USE time by the module that owns it, so a live
server can be re-tuned without a restart. Names and defaults are the
JAX package's, so one deployment manifest configures either package.
The port has no histogram-implementation switch: the histogram build
dispatches on the tensor's device (ops/histogram.py).

| env var | default | meaning |
|---|---|---|
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

import os

__all__ = ["default_nbins", "hist_bytes_budget", "arrow_csv_enabled",
           "ingest_chunk_bytes", "svmlight_dense_budget"]


def default_nbins() -> int:
    """H2O_TPU_NBINS (default 256), validated to [4, 256]."""
    raw = os.environ.get("H2O_TPU_NBINS", "256")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"bad H2O_TPU_NBINS={raw!r}: not an int") from None
    if not 4 <= n <= 256:
        raise ValueError(f"bad H2O_TPU_NBINS={raw!r}: nbins must be in "
                         "[4, 256]")
    return n


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
