#!/usr/bin/env python3
"""Warm-train timing of the PyTorch port's GBM at bench.py's on-chip
shape, for comparing two checkouts of the port on one card.

    PYTHONPATH=<checkout> python3 tools/torch_gbm_timing.py [--repeats N]

It imports ``h2o_kubernetes_tpu_torch`` from PYTHONPATH (so the same
script times any checkout), builds bench.py's table (1,000,000 rows: 8
normal columns, an 8-level enum, an exponential column, a logistic
label; bench.py:137-146) on the CUDA card, trains GBM(ntrees=10,
max_depth=5, learn_rate=0.2, seed=1) once to bin and warm up, then N
more times, and prints one JSON line: the card, the package path, each
warm train's wall seconds (each ends on host metrics) and their median.
It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_gbm_timing: no CUDA device", file=sys.stderr)
        return 2
    import h2o_kubernetes_tpu_torch as port

    rows = 1_000_000
    rng = np.random.default_rng(args.seed)
    cols = {f"x{i}": rng.normal(size=rows).astype(np.float32)
            for i in range(8)}
    cols["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8, size=rows)]
    cols["dep_delay"] = rng.exponential(10.0, size=rows).astype(np.float32)
    logit = (1.2 * cols["x0"] - 0.8 * cols["x1"]
             + 0.05 * cols["dep_delay"] - 1.0
             + rng.normal(scale=0.5, size=rows))
    cols["y"] = np.where(logit > 0, "late", "ontime")
    frame = port.Frame.from_arrays(cols)

    def train():
        return port.GBM(ntrees=10, max_depth=5, learn_rate=0.2,
                        seed=1).train(y="y", training_frame=frame)

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
    print(json.dumps({"card": card, "package": port.__file__,
                      "first_s": first, "warm_s": times,
                      "median_s": statistics.median(times),
                      "train_auc": model.scoring_history[-1]["train_auc"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
