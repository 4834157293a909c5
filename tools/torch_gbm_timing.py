#!/usr/bin/env python3
"""Warm-train timing of the PyTorch port at its on-chip training shapes,
for comparing two checkouts of the port on one card.

    PYTHONPATH=<checkout> python3 tools/torch_gbm_timing.py \
        [--model gbm|drf|multinomial] [--repeats N]

It imports ``h2o_kubernetes_tpu_torch`` from PYTHONPATH (so the same
script times any checkout) and builds on the CUDA card, by ``--model``:

- ``gbm`` (default): bench.py's table (1,000,000 rows: 8 normal columns,
  an 8-level enum, an exponential column, a logistic label;
  bench.py:137-146), GBM(ntrees=10, max_depth=5, learn_rate=0.2, seed=1);
- ``drf``: drf_higgs (tools/bench_suite.py:225-232), 1,000,000
  HIGGS-shaped rows (tools/datasets.py:159-170), DRF(ntrees=10,
  max_depth=8, seed=1);
- ``multinomial``: gbm_multinomial (tools/bench_suite.py:243-265),
  500,000 rows x 10 normal columns, 4 classes, GBM(ntrees=5,
  max_depth=5, learn_rate=0.2, seed=1).

It trains once to bin and warm up, then N more times, and prints one
JSON line: the card, the model, the package path, each warm train's wall
seconds (each ends on host metrics) and their median. It exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def workload(port, model: str, seed: int = 0):
    """(frame on the card, estimator factory) of one ``--model``; the
    table is made from ``seed``."""
    rng = np.random.default_rng(seed)
    domains = None
    if model == "gbm":
        rows = 1_000_000
        cols = {f"x{i}": rng.normal(size=rows).astype(np.float32)
                for i in range(8)}
        cols["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8,
                                                             size=rows)]
        cols["dep_delay"] = rng.exponential(10.0, size=rows).astype(
            np.float32)
        logit = (1.2 * cols["x0"] - 0.8 * cols["x1"]
                 + 0.05 * cols["dep_delay"] - 1.0
                 + rng.normal(scale=0.5, size=rows))
        cols["y"] = np.where(logit > 0, "late", "ontime")
        make = functools.partial(port.GBM, ntrees=10, max_depth=5,
                                 learn_rate=0.2, seed=1)
    elif model == "drf":
        rows = 1_000_000
        X = rng.normal(size=(rows, 28)).astype(np.float32)
        logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] * X[:, 2]
                 + 0.5 * np.abs(X[:, 3]) - 0.4 * (X[:, 4] ** 2)
                 + rng.normal(scale=0.7, size=rows))
        cols = {f"f{i}": X[:, i] for i in range(28)}
        cols["y"] = (logit > 0).astype(np.float32)
        domains = {"y": ["b", "s"]}
        make = functools.partial(port.DRF, ntrees=10, max_depth=8, seed=1)
    else:
        rows = 500_000
        X = rng.normal(size=(rows, 10)).astype(np.float32)
        score = X[:, 0] + 0.5 * X[:, 1]
        cols = {f"f{i}": X[:, i] for i in range(10)}
        cols["y"] = np.where(score > 0.6, "a", np.where(
            score < -0.6, "b", np.where(X[:, 2] > 0, "c", "d")))
        make = functools.partial(port.GBM, ntrees=5, max_depth=5,
                                 learn_rate=0.2, seed=1)
    return port.Frame.from_arrays(cols, domains=domains), make


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--model", choices=("gbm", "drf", "multinomial"),
                    default="gbm")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gbm_timing: no CUDA device", file=sys.stderr)
        return 2
    import h2o_kubernetes_tpu_torch as port

    frame, make = workload(port, args.model, args.seed)

    def train():
        return make().train(y="y", training_frame=frame)

    t0 = time.perf_counter()
    train()
    first = time.perf_counter() - t0
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        model = train()
        times.append(time.perf_counter() - t0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "model": args.model,
                      "package": port.__file__, "first_s": first,
                      "warm_s": times, "median_s": statistics.median(times),
                      "scoring": model.scoring_history[-1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
