"""Environment knobs read by the serving slice of the port.

Each knob is read at USE time by the module that owns it, so a live
server can be re-tuned without a restart. Names and defaults are the
JAX package's, so one deployment manifest configures either package.

| env var | default | meaning |
|---|---|---|
| H2O_TPU_SCORE_BATCH_US | 2000 | REST scoring micro-batcher window, µs; 0 = dispatch immediately (rest.py) |
| H2O_TPU_SCORE_TIMEOUT | 60 | seconds a scoring request may wait for its micro-batched result before 503 (rest.py) |
| H2O_TPU_SCORE_QUEUE_MAX | 256 | scoring admission-queue bound: requests past it are load-shed with 429 + Retry-After; <=0 unbounded (rest.py) |
| H2O_TPU_SCORE_MAX_ROWS | 100000 | per-request row cap on the inline scoring route (413 past it) |
| H2O_TPU_CONTRIB_MAX_ROWS | 100000 | per-request row cap on the TreeSHAP contributions route (413 past it; rest.py) |
| H2O_TPU_CONTRIB_CHUNK | 16384 | upper bound on rows per device TreeSHAP dispatch, pow2-floored (models/base.py) |
| H2O_TPU_POOL_WARM_BUCKETS | 128,1024 | default warm-up ladder: Model.warm_up runs every pow2 batch bucket up to the largest listed before a replica's readyz flips (models/base.py) |
| H2O_TPU_BREAKER_FAILURES | 5 | consecutive device-dispatch errors that trip the serving circuit breaker open (runtime/lifecycle.py) |
| H2O_TPU_BREAKER_COOLDOWN | 30 | seconds the breaker stays open before admitting the half-open probe (runtime/lifecycle.py) |
| H2O_TPU_DRAIN_TIMEOUT | 30 | seconds the drain waits for the batcher flush (runtime/lifecycle.py) |
"""

__all__: list[str] = []
