"""How far a one-ulp change of the column statistics moves AutoML's
DeepLearning_1 train (hidden (64, 64), 10 epochs, Adam) on
airlines rows, in the JAX package and in the port, on the CPU.

Each package trains twice on the same rows (``tools/datasets.
airlines_arrays``, response IsDepDelayed): once as is, and once with
every numeric column's sigma moved up by one float32 ulp
(``np.nextafter``) before ``DataInfo`` standardizes with it. The JAX
package's rollups are patched in this process only; none of its files
changes. Prints one JSON line per seed and package: the largest and
the mean gap of the training rows' class-1 probabilities between the
two trains, and the gaps of their AUC and logloss.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/dl_sigma_ulp.py \\
        [--rows 5000] [--seeds 1,2,3,4,5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_DL = dict(hidden=(64, 64), epochs=10)
_Y = "IsDepDelayed"


def _up(sigma: float) -> float:
    return float(np.nextafter(np.float32(sigma), np.float32(np.inf)))


def _gaps(p0: np.ndarray, p1: np.ndarray, m0: dict, m1: dict) -> dict:
    d = np.abs(p0.astype(np.float64) - p1.astype(np.float64))
    return {"max_prob_gap": float(d.max()),
            "mean_prob_gap": float(d.mean()),
            "auc_gap": abs(m0["auc"] - m1["auc"]),
            "logloss_gap": abs(m0["logloss"] - m1["logloss"])}


def _jax(cols, dom, seed: int) -> dict:
    import h2o_kubernetes_tpu as h2o
    from h2o_kubernetes_tpu.frame import frame as jframe
    from h2o_kubernetes_tpu.models.deeplearning import DeepLearning
    from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh

    plain = jframe.Vec._compute_rollups

    def moved(self):
        r = plain(self)
        return dict(r, sigma=_up(r["sigma"])) if r["rows"] > 1 else r

    out = []
    for patch in (False, True):
        jframe.Vec._compute_rollups = moved if patch else plain
        try:
            with use_mesh(make_mesh(n_rows=1)):
                fr = h2o.Frame.from_arrays(cols, domains=dom)
                t0 = time.perf_counter()
                m = DeepLearning(**_DL, seed=seed).train(
                    y=_Y, training_frame=fr)
                secs = time.perf_counter() - t0
                p = np.asarray(m.predict_raw(fr))[: fr.nrows, 1]
                perf = m.model_performance(fr, y=_Y)
        finally:
            jframe.Vec._compute_rollups = plain
        out.append((p, perf, secs))
    return dict(_gaps(out[0][0], out[1][0], out[0][1], out[1][1]),
                train_s=[o[2] for o in out])


def _port(cols, dom, seed: int) -> dict:
    import torch

    from h2o_kubernetes_tpu_torch import DeepLearning, Frame
    from h2o_kubernetes_tpu_torch.frame import frame as tframe

    torch.set_num_threads(1)        # the DL train's fastest on a CPU
    plain = tframe.Vec.rollups

    def moved(self):
        r = plain(self)
        return dict(r, sigma=_up(r["sigma"])) if r["rows"] > 1 else r

    out = []
    for patch in (False, True):
        tframe.Vec.rollups = moved if patch else plain
        try:
            fr = Frame.from_arrays(cols, domains=dom, device="cpu")
            t0 = time.perf_counter()
            m = DeepLearning(**_DL, seed=seed).train(y=_Y,
                                                     training_frame=fr)
            secs = time.perf_counter() - t0
            p = m.predict_raw(fr)[:, 1]
            perf = m.model_performance(fr, y=_Y)
        finally:
            tframe.Vec.rollups = plain
        out.append((p, perf, secs))
    return dict(_gaps(out[0][0], out[1][0], out[0][1], out[1][1]),
                train_s=[o[2] for o in out])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--seeds", default="1")
    args = ap.parse_args()
    from tools.datasets import airlines_arrays

    cols, dom = airlines_arrays(args.rows, seed=0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, fn in (("jax", _jax), ("port", _port)):
            print(json.dumps({"package": name, "rows": args.rows,
                              "train": "DeepLearning_1", "seed": seed,
                              **fn(cols, dom, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
